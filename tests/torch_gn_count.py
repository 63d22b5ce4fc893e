"""Counts of the port's Gauss-Newton loops, taken from outside the package.

`counting()` wraps `ops/control.while_loop` where it runs one of the two
unrolled ICP loops (`registration.gauss_newton_loop`, and
`gauss_newton_loop_lockstep`) and the functions that apply one iteration's
increment (`registration._apply_increment` / `_apply_increments`, called
once per iteration, frozen or not). Each loop run live gives one record:

  * trips: the loop body's calls (the convergence test read True);
  * evals: the iterations the body ran, frozen ones included;
  * body_syncs, cond_syncs (while `syncs`, a function giving the number of
    host syncs so far, is set): the syncs taken while the body ran, and the
    rest of the loop's: its tests and their host reads.

Used by tests/test_torch_gn_unroll.py, tests/test_torch_nn_modes.py and
chip_smoke.py's phase "unroll". Imports no JAX.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

GN_BODIES = ("gauss_newton_loop.<locals>.body",
             "gauss_newton_loop_lockstep.<locals>.body")


class GNCount:
    def __init__(self, syncs: Optional[Callable[[], int]] = None):
        self.loops: List[dict] = []
        self.syncs = syncs  # may be set or cleared while the count is open
        self._current: Optional[dict] = None

    def reset(self) -> None:
        self.loops = []

    def total(self, key: str) -> int:
        return sum(loop[key] for loop in self.loops)


@contextlib.contextmanager
def counting(syncs: Optional[Callable[[], int]] = None):
    """Yield a GNCount filled while the context is open; the wrapped
    functions are restored on exit."""
    from kiss_icp_tpu_torch.ops import control, registration

    rec = GNCount(syncs)
    real_loop = control.while_loop
    real_apply = registration._apply_increment
    real_apply_rows = registration._apply_increments

    def now() -> int:
        return rec.syncs() if rec.syncs is not None else 0

    def while_loop(cond_fn, body_fn, carry, name):
        if getattr(body_fn, "__qualname__", "") not in GN_BODIES:
            return real_loop(cond_fn, body_fn, carry, name)
        loop = {"trips": 0, "evals": 0, "cond_syncs": 0, "body_syncs": 0}
        rec.loops.append(loop)

        def body(*c):
            loop["trips"] += 1
            s0 = now()
            out = body_fn(*c)
            loop["body_syncs"] += now() - s0
            return out

        rec._current = loop
        s0 = now()
        try:
            return real_loop(cond_fn, body, carry, name)
        finally:
            rec._current = None
            # What the loop took outside its body: the tests and their reads.
            loop["cond_syncs"] = now() - s0 - loop["body_syncs"]

    def counted(fn):
        def wrapper(*a, **k):
            if rec._current is not None:
                rec._current["evals"] += 1
            return fn(*a, **k)
        return wrapper

    control.while_loop = while_loop
    registration._apply_increment = counted(real_apply)
    registration._apply_increments = counted(real_apply_rows)
    try:
        yield rec
    finally:
        control.while_loop = real_loop
        registration._apply_increment = real_apply
        registration._apply_increments = real_apply_rows
