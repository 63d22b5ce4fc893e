"""The benchmark's command line: one run of one cell on the card.

    python3 -m odobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints a few lines about the run, the compared numbers with their limits as
the last lines of standard error, and the result object as the last line of
standard output. Without a CUDA card (or with fewer cards than the cell
asks for) it exits with code 2 and prints no result: the measurement never
falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _pin_caches() -> None:
    """Kernel caches a library may keep go inside the checkout, at fixed
    paths, so that only a cell's first run in a checkout compiles."""
    cache = CHECKOUT / ".odobench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)


def _pin_cores() -> None:
    """The run's threads on the last four of the host cores it may use, the
    same cores in every run: the port's host work is one thread issuing
    kernels, and a thread that moves between cores spreads the rate."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-4:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    _pin_cores()

    import torch

    from odobench.harness import Layout, emit, run_cell

    # One process, few threads: the port's host work is single-threaded.
    torch.set_num_threads(2)

    chips = int(Layout(CHECKOUT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"odobench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda:0", t_start=T_START, root=CHECKOUT)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
