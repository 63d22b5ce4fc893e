"""Structured control flow with one body and two drivers.

The step's loops (the Gauss-Newton iterations, the map's claim rounds) and
its one branch (the empty-map shortcut) are written as functions of their
carry, as the JAX package writes them for `lax.while_loop` / `lax.cond`.

  * Under a trace (`torch.export.export`, or `torch.compile`), where
    `torch.compiler.is_compiling()` is true, the helpers emit
    `torch.while_loop` / `torch.cond`, so the exported program keeps the
    loop and the branch.
  * Otherwise they run a plain Python `while` / `if` with one `bool()` read
    per test. `torch.while_loop` and `torch.cond` called eagerly go through
    `torch.compile`, which the live path must never do.

Each loop and branch has a name. Run live under a profiler (trace.py), a
test's read is the span `kiss/sync/<name>` and a loop's trip, from the read
that let it run up to the next read, is `kiss/<name>_trip`.

The bodies follow `torch.while_loop`'s rules: they return new tensors of the
carry's shapes and types and never alias their inputs (`fresh` copies a
tensor that a branch would otherwise return as it came, under a trace only).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from kiss_icp_tpu_torch import trace


def tracing() -> bool:
    """True while `torch.export` or `torch.compile` traces the caller."""
    return torch.compiler.is_compiling()


def while_loop(cond_fn: Callable, body_fn: Callable, carry: Sequence, name: str) -> Tuple:
    """`carry = body_fn(*carry)` while `cond_fn(*carry)`; returns the carry."""
    carry = tuple(carry)
    if tracing():
        return tuple(torch.while_loop(cond_fn, body_fn, carry))
    trip = f"kiss/{name}_trip"
    test = cond_fn(*carry)
    while trace.read(name, bool, test):
        with trace.span(trip):
            carry = tuple(body_fn(*carry))
            test = cond_fn(*carry)
    return carry


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
         operands: Sequence, name: str):
    """`true_fn(*operands)` if `pred` else `false_fn(*operands)`."""
    operands = tuple(operands)
    if tracing():
        return torch.cond(pred, true_fn, false_fn, operands)
    return true_fn(*operands) if trace.read(name, bool, pred) else false_fn(*operands)


def fresh(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when running eagerly; a copy under a trace, where a loop
    body or branch may not return one of its inputs unchanged."""
    return t.clone() if tracing() else t
