"""The port's native scan IO and prefetcher (kiss_icp_tpu_torch/io/native.py
over native/scan_io.cpp): the twin of tests/test_native_io.py, against the
numpy decoders.

The library is built once for this file from native/scan_io.cpp with g++
into a temporary directory, as tests/test_torch_datasets.py builds it (`make
native` puts it beside io/native.py), and both packages' bindings load it:
every decode is also held to the JAX binding's on the same file. The
prefetcher's life cycle: the capacity cap, order and content, an empty file
list, an unreadable file surfacing its path, close() exhausting the
iterator, and 50 create/park/close cycles with the workers parked on a full
ring, run in a child process under a time limit so that a deadlock fails the
test instead of hanging the suite.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kiss_icp_tpu.io import native as jnative
from kiss_icp_tpu_torch.io import native

REPO = Path(__file__).resolve().parent.parent
# The 50 cycles take about a second; a deadlocked close() never returns.
HAMMER_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The built library's path, loaded by both packages' bindings."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build native/scan_io.cpp")
    path = tmp_path_factory.mktemp("native") / "libkisstpu_native.so"
    subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-o", str(path),
                    str(REPO / "native" / "scan_io.cpp")], check=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        for module in (native, jnative):
            mp.setattr(module, "_LIB_PATH", str(path))
            mp.setattr(module, "_lib", None)
            assert module.available()
        yield path


def _write_kitti_bin(path, pts):
    arr = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    arr.astype(np.float32).tofile(path)


def _read(path, fmt, **kw):
    """The port's native decode of `path`, equal to JAX's."""
    out = native.read_scan(path, fmt, **kw)
    np.testing.assert_array_equal(out, jnative.read_scan(path, fmt, **kw))
    return out


def test_read_scan_kitti(lib, tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-50, 50, (1000, 3)).astype(np.float32)
    f = tmp_path / "scan.bin"
    _write_kitti_bin(f, pts)
    out = _read(f, native.FORMAT_F32X4)
    np.testing.assert_allclose(out, pts, atol=1e-6)


def test_read_scan_drops_nan(lib, tmp_path):
    pts = np.array([[1, 2, 3], [np.nan, 0, 0], [4, 5, 6]], np.float32)
    f = tmp_path / "scan.bin"
    _write_kitti_bin(f, pts)
    out = _read(f, native.FORMAT_F32X4)
    assert out.shape == (2, 3)


def test_read_scan_boreas_stride(lib, tmp_path):
    rng = np.random.default_rng(1)
    rec = rng.uniform(-10, 10, (64, 6)).astype(np.float32)
    f = tmp_path / "scan.bin"
    rec.tofile(f)
    out = _read(f, native.FORMAT_F32X6)
    np.testing.assert_allclose(out, rec[:, :3], atol=1e-6)


def test_read_scan_nclt(lib, tmp_path):
    pts_true = np.array([[1.0, 2.0, -0.5], [10.0, -3.0, 1.0]])
    x = np.round((pts_true[:, 0] + 100.0) / 0.005).astype(np.int16)
    y = np.round((-pts_true[:, 1] + 100.0) / 0.005).astype(np.int16)
    z = np.round((-pts_true[:, 2] + 100.0) / 0.005).astype(np.int16)
    rec = np.stack([x, y, z, np.zeros_like(x)], axis=1).ravel()
    f = tmp_path / "scan.bin"
    rec.tofile(f)
    out = _read(f, native.FORMAT_NCLT)
    np.testing.assert_allclose(out, pts_true, atol=0.005)
    np.testing.assert_allclose(native.read_nclt_scan(f), pts_true, atol=0.005)


def test_capacity_cap(lib, tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-50, 50, (1000, 3)).astype(np.float32)
    f = tmp_path / "scan.bin"
    _write_kitti_bin(f, pts)
    out = _read(f, native.FORMAT_F32X4, capacity=100)
    assert out.shape == (100, 3)


def test_prefetcher_order_and_content(lib, tmp_path):
    rng = np.random.default_rng(3)
    files, truths = [], []
    for i in range(12):
        pts = rng.uniform(-50, 50, (200 + i, 3)).astype(np.float32)
        f = tmp_path / f"{i:04d}.bin"
        _write_kitti_bin(f, pts)
        files.append(str(f))
        truths.append(pts)
    pre = native.ScanPrefetcher(files, native.FORMAT_F32X4, depth=3, threads=3)
    assert pre._handle is not None  # the native ring, not the numpy fallback
    got = list(pre)
    assert len(got) == 12
    for g, t in zip(got, truths):
        np.testing.assert_allclose(g, t, atol=1e-6)
    pre.close()


def test_prefetcher_empty(lib):
    pre = native.ScanPrefetcher([], native.FORMAT_F32X4)
    assert list(pre) == []


def test_prefetcher_surfaces_unreadable_file(lib, tmp_path):
    """A missing file mid-sequence raises IOError naming the path instead of
    yielding an empty scan, and the sequence continues past it."""
    rng = np.random.default_rng(4)
    good = tmp_path / "a.bin"
    _write_kitti_bin(good, rng.random((50, 3)).astype(np.float32))
    missing = tmp_path / "missing.bin"  # never created
    good2 = tmp_path / "c.bin"
    _write_kitti_bin(good2, rng.random((30, 3)).astype(np.float32))

    pre = native.ScanPrefetcher([str(good), str(missing), str(good2)],
                                native.FORMAT_F32X4, capacity=1024)
    assert next(pre).shape == (50, 3)
    with pytest.raises(IOError, match="missing.bin"):
        next(pre)
    assert next(pre).shape == (30, 3)
    pre.close()


def test_prefetcher_close_exhausts_iterator(lib, tmp_path):
    """Iterating after close() raises StopIteration instead of restarting
    the sequence through the numpy fallback."""
    f = tmp_path / "a.bin"
    _write_kitti_bin(f, np.random.default_rng(5).random((20, 3)).astype(np.float32))
    pre = native.ScanPrefetcher([str(f), str(f)], native.FORMAT_F32X4, capacity=256)
    next(pre)
    pre.close()
    with pytest.raises(StopIteration):
        next(pre)


def test_truncated_file_native_numpy_parity(lib, tmp_path):
    """A truncated .bin (a partial trailing record) decodes to the same
    floored point set through the native decoder and the numpy one."""
    pts = np.random.default_rng(6).random((40, 3)).astype(np.float32)
    f = tmp_path / "t.bin"
    _write_kitti_bin(f, pts)
    f.write_bytes(f.read_bytes()[:-7])  # chop mid-record

    nat = _read(str(f), native.FORMAT_F32X4, capacity=1024)
    fall = native._numpy_decode(str(f), native.FORMAT_F32X4, 1024)
    assert nat.shape == fall.shape == (39, 3)
    np.testing.assert_array_equal(nat, fall)
    np.testing.assert_array_equal(fall, jnative._numpy_decode(str(f), native.FORMAT_F32X4, 1024))


HAMMER = """
import sys
import numpy as np
from kiss_icp_tpu_torch.io import native
native._LIB_PATH = sys.argv[1]
assert native.available()
files = sys.argv[2:]
for _ in range(50):  # create, park the workers on a full ring, destroy
    pre = native.ScanPrefetcher(files, native.FORMAT_F32X4, capacity=256, depth=2, threads=4)
    next(pre)  # the pipeline is flowing before teardown
    pre.close()
print("ok")
"""


def test_destroy_while_blocked_does_not_hang(lib, tmp_path):
    """close() with workers parked on a full ring must not deadlock on the
    lost-wakeup race (stop flips under the mutex). The cycles run in a child
    process: one that outlives HAMMER_TIMEOUT_S is killed and fails here."""
    rng = np.random.default_rng(7)
    files = []
    for i in range(32):
        f = tmp_path / f"{i}.bin"
        _write_kitti_bin(f, rng.random((10, 3)).astype(np.float32))
        files.append(str(f))
    out = subprocess.run([sys.executable, "-c", HAMMER, str(lib), *files], cwd=REPO,
                         capture_output=True, text=True, timeout=HAMMER_TIMEOUT_S)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
