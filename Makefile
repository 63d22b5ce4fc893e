NATIVE_SRC := native/scan_io.cpp
NATIVE_LIB := kiss_icp_tpu/io/libkisstpu_native.so
# The PyTorch port keeps its own copy beside kiss_icp_tpu_torch/io/native.py.
NATIVE_LIB_TORCH := kiss_icp_tpu_torch/io/libkisstpu_native.so
CXX ?= g++
CXXFLAGS := -O3 -std=c++17 -fPIC -shared -pthread -Wall -Wextra

.PHONY: all native test clean install editable bench

all: native

native: $(NATIVE_LIB) $(NATIVE_LIB_TORCH)

$(NATIVE_LIB) $(NATIVE_LIB_TORCH): $(NATIVE_SRC)
	$(CXX) $(CXXFLAGS) -o $@ $^

test: native
	python -m pytest tests/ -q

install: native
	pip install --no-build-isolation .

editable: native
	pip install --no-build-isolation -e .

bench: native
	python bench.py

clean:
	rm -f $(NATIVE_LIB) $(NATIVE_LIB_TORCH)
