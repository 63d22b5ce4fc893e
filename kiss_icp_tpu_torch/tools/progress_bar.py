"""tqdm progress range (reference tools/progress_bar.py:26-27)."""

from __future__ import annotations


def get_progress_bar(first: int, last: int, desc: str = ""):
    try:
        from tqdm import trange

        return trange(first, last, unit=" frames", desc=desc, dynamic_ncols=True)
    except ImportError:
        return range(first, last)
