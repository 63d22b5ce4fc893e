"""Structured control flow: one body, run three ways.

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
  * A loop whose caller gives a `graph_key` runs, on CUDA tensors and
    outside a trace, each trip as the replay of one CUDA graph of the body
    and the next test (`TripGraph`): the host issues one graph launch a
    trip instead of the body's kernels, and reads the test as before.

Each loop and branch has a name. Run live under a profiler (trace.py), a
test's read is the span `kiss/sync/<name>` and a loop's trip, from the read
that let it run up to the next read, is `kiss/<name>_trip`; inside a trip,
a graph's capture is `kiss/<name>_capture` and its replay
`kiss/<name>_replay`.

The bodies follow `torch.while_loop`'s rules: they return new tensors of the
carry's shapes and types and never alias their inputs (`fresh` copies a
tensor that a branch would otherwise return as it came, under a trace only).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable, Optional, Sequence, Tuple

import torch

from kiss_icp_tpu_torch import trace


def tracing() -> bool:
    """True while `torch.export` or `torch.compile` traces the caller."""
    return torch.compiler.is_compiling()


def while_loop(cond_fn: Callable, body_fn: Callable, carry: Sequence, name: str, *,
               inputs: Sequence[torch.Tensor] = (), tables: Sequence[torch.Tensor] = (),
               graph_key: Optional[Hashable] = None) -> Tuple:
    """`carry = body_fn(*carry, *inputs, *tables)` while `cond_fn(*carry)`;
    returns the carry.

    `inputs` and `tables` are the tensors the body reads besides its carry;
    the body reads no other tensor. `graph_key` (hashable, or None): what
    the body computes besides those tensors' values (its constants, the
    functions it calls). Given one, with CUDA tensors and no trace, the
    loop runs on `TripGraph`: a graph reads copies of `inputs`, made once a
    call, and `tables` where they lie, so a table's address is part of the
    graph's key (`capture_key`). Without one, the Python loop."""
    carry = tuple(carry)
    extra = tuple(inputs) + tuple(tables)
    if tracing():
        return tuple(torch.while_loop(cond_fn, lambda *c: body_fn(*c, *extra), carry))
    if uses_graph(carry, graph_key):
        return _graph_while_loop(cond_fn, body_fn, carry, name, tuple(inputs), tuple(tables),
                                 graph_key)
    trip = f"kiss/{name}_trip"
    test = cond_fn(*carry)
    while trace.read(name, bool, test):
        with trace.span(trip):
            carry = tuple(body_fn(*carry, *extra))
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


# --- CUDA graphs over a loop trip -------------------------------------------

# Graphs kept, the least recently used dropped first: one for each set of
# tables a process runs on (a state, each row of a batch run row by row).
MAX_GRAPHS = 16

_graphs: "collections.OrderedDict[Hashable, TripGraph]" = collections.OrderedDict()
_graphs_lock = threading.Lock()
_capture_streams = {}

# Objects whose `launches` attribute counts a kernel's launches
# (kernels/nn27.py, kernels/linsys.py): a replay adds what its capture
# launched.
_launch_counters = []


def count_launches(counter) -> None:
    """Register an object with a `launches` count: each graph replay adds
    the launches that its capture recorded."""
    _launch_counters.append(counter)


def uses_graph(carry: Sequence[torch.Tensor], graph_key: Optional[Hashable]) -> bool:
    """Whether `while_loop` runs this loop on CUDA graphs: a key given, no
    trace, and a carry on a CUDA device."""
    return (graph_key is not None and not tracing()
            and all(t.device.type == "cuda" for t in carry))


def capture_key(name: str, statics: Hashable, carry: Sequence[torch.Tensor],
                inputs: Sequence[torch.Tensor], tables: Sequence[torch.Tensor]) -> Tuple:
    """The key of a loop's trip graph: its name, the caller's `statics`,
    the device, shape, type and strides of every tensor, and the address of
    each table (a graph reads a table where it lay at capture)."""
    def layout(t):
        return (t.device, t.dtype, tuple(t.shape), t.stride())

    return (name, statics, tuple(layout(t) for t in tuple(carry) + tuple(inputs)),
            tuple(layout(t) + (t.data_ptr(),) for t in tables))


def clear_graphs() -> None:
    """Drop every kept graph, with its buffers and memory pool."""
    with _graphs_lock:
        _graphs.clear()


class TripGraph:
    """One loop trip (the body, then the test) as a CUDA graph over buffers
    of its own: the carry, a copy of the inputs, and the test's flag.

    The first trip runs eagerly on a side stream, which also readies the
    libraries' handles and workspaces there, and is then captured on that
    stream without running; each later trip is one replay on the current
    stream. A replay writes the next carry and the test into the buffers.
    A call the body makes through `outside_graph` splits the graph: the
    parts share one memory pool, and a replay runs the call between them.
    Capture leaves the launch counters as they were; a replay adds what the
    capture launched, so the counters count every kernel the card ran."""

    def __init__(self, carry: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor]):
        self.carry = tuple(torch.empty_like(t) for t in carry)
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        self.test = torch.empty((), dtype=torch.bool, device=carry[0].device)
        self.parts = []  # the captured graphs, in the trip's order
        self.holes = []  # (fn, args, out) run between part i and part i + 1
        self.launched = ()
        self._open = False

    def load(self, carry: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor]) -> None:
        """Copy a call's carry and inputs into the graph's buffers."""
        for dst, src in zip(self.carry + self.inputs, tuple(carry) + tuple(inputs)):
            dst.copy_(src)

    def capture(self, cond_fn: Callable, body_fn: Callable,
                tables: Sequence[torch.Tensor]) -> None:
        """Run this trip eagerly, then capture it: both on the side stream."""
        def trip():
            out = body_fn(*self.carry, *self.inputs, *tables)
            for dst, src in zip(self.carry, out):
                dst.copy_(src)
            self.test.copy_(cond_fn(*self.carry))

        dev = self.test.device
        current = torch.cuda.current_stream(dev)
        side = _capture_streams.get(dev)
        if side is None:
            side = _capture_streams.setdefault(dev, torch.cuda.Stream(dev))
        side.wait_stream(current)
        with torch.cuda.stream(side):
            trip()
            before = [c.launches for c in _launch_counters]
            _capturing.graph = self
            try:
                self._begin()
                trip()
            finally:
                _capturing.graph = None
                if self._open:
                    self._end()
                launched = [c.launches - b for c, b in zip(_launch_counters, before)]
                for c, b in zip(_launch_counters, before):
                    c.launches = b
        current.wait_stream(side)
        self.launched = tuple(launched)

    def _begin(self) -> None:
        part = torch.cuda.CUDAGraph()
        # thread_local: a capture forbids unsafe calls in its own thread
        # only, not in the process's other threads.
        part.capture_begin(pool=self.parts[0].pool() if self.parts else None,
                           capture_error_mode="thread_local")
        self.parts.append(part)
        self._open = True

    def _end(self) -> None:
        self._open = False
        self.parts[-1].capture_end()

    def split(self, fn: Callable, args: Sequence[torch.Tensor]):
        """End the part being captured at a call of `fn(*args)`, run it once
        to hold its result's buffers (which the next part reads), and begin
        the next part."""
        self._end()
        out = fn(*args)
        self.holes.append((fn, tuple(args), out))
        self._begin()
        return out

    def replay(self) -> None:
        for i, part in enumerate(self.parts):
            part.replay()
            if i < len(self.holes):
                fn, args, out = self.holes[i]
                out.copy_(fn(*args))
        for c, n in zip(_launch_counters, self.launched):
            c.launches += n


# The TripGraph this thread is capturing, if any (`outside_graph`).
_capturing = threading.local()


def outside_graph(fn: Callable, *args: torch.Tensor) -> torch.Tensor:
    """`fn(*args)`, a call that a CUDA graph cannot hold (a library call
    that allocates device memory or waits on the host). Inside a trip being
    captured, the graph leaves it out: each replay makes the call between
    the graph's parts, at the same point of the trip, on tensors at the
    same addresses. Elsewhere, the call itself."""
    graph = getattr(_capturing, "graph", None)
    return fn(*args) if graph is None else graph.split(fn, args)


def _graph_while_loop(cond_fn, body_fn, carry, name, inputs, tables, statics):
    """`while_loop` on a `TripGraph`: the one kept under the loop's key, or
    one captured at this call's first trip."""
    key = capture_key(name, statics, carry, inputs, tables)
    with _graphs_lock:
        graph = _graphs.get(key)
        if graph is not None:
            _graphs.move_to_end(key)
    if graph is None:
        graph = TripGraph(carry, inputs)
    graph.load(carry, inputs)
    trip = f"kiss/{name}_trip"
    test = cond_fn(*carry)
    while trace.read(name, bool, test):
        with trace.span(trip):
            if not graph.parts:
                with trace.span(f"kiss/{name}_capture"):
                    graph.capture(cond_fn, body_fn, tables)
                with _graphs_lock:
                    _graphs[key] = graph
                    while len(_graphs) > MAX_GRAPHS:
                        _graphs.popitem(last=False)
            else:
                with trace.span(f"kiss/{name}_replay"):
                    graph.replay()
        test = graph.test
    # The buffers are the next call's: the caller gets copies.
    return tuple(t.clone() for t in graph.carry)
