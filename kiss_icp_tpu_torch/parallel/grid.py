"""The port's device grid: named axes, each R process ranks x L local rows.

The JAX package runs its multi-device programs as one SPMD `shard_map` over
a `Mesh` of devices, and its tests run them on a virtual 8-device CPU mesh
in one process. Here a grid axis of extent E is R process ranks (joined by
`torch.distributed`, one device a rank) times L rows stacked on a leading
tensor axis in each process: E = R x L. One card, or the CPU in one
process, is R = 1, L = E: the counterpart of JAX's virtual mesh.

Every collective of the JAX programs is written once, as two steps: gather
the local (L, ...) block from the R ranks (nothing to do when R = 1), then
reduce over the E rows in index order (`GridAxis.total`). The order is
fixed, so a run gives the same bits whether its rows sit as 1 x E or as
R x E/R.

Backends are named by the caller or the environment and never picked by
catching a failure: gloo carries CPU tensors, NCCL carries CUDA tensors with
one card a rank. A payload on the wrong side of its group's backend raises.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """(ranks, this rank) of the initialised default process group; (1, 0)
    when there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def check_payload(group, x: torch.Tensor) -> None:
    """Raise when `x` cannot cross `group`'s backend: gloo carries CPU
    tensors, NCCL CUDA tensors."""
    backend = dist.get_backend(group)
    if backend == "gloo" and x.device.type != "cpu":
        raise RuntimeError(f"a {x.device} tensor cannot cross a gloo group: a CUDA "
                           "payload across ranks needs NCCL, one card a rank")
    if backend == "nccl" and x.device.type != "cuda":
        raise RuntimeError(f"a {x.device} tensor cannot cross an NCCL group: NCCL "
                           "carries CUDA tensors; host payloads need gloo")


@dataclasses.dataclass(frozen=True)
class GridAxis:
    """One grid axis: `extent` rows, `ranks` processes of `extent // ranks`
    local rows each; this process is the `index`-th along the axis, and
    `group` joins the processes along it (None when ranks is 1)."""

    extent: int
    ranks: int = 1
    index: int = 0
    group: Optional[object] = None

    def __post_init__(self):
        if self.extent < 1 or self.extent % self.ranks:
            raise ValueError(f"an axis of {self.extent} rows does not split over "
                             f"{self.ranks} ranks")

    @property
    def local(self) -> int:
        """L: the rows this process holds."""
        return self.extent // self.ranks

    @property
    def offset(self) -> int:
        """Index of this process's first row along the axis."""
        return self.index * self.local

    def rows(self, device=None) -> torch.Tensor:
        """(L,) int64 global indices of this process's rows."""
        return torch.arange(self.offset, self.offset + self.local, device=device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) local block -> (E, ...) rows of every rank, in order."""
        if self.ranks == 1:
            return x
        check_payload(self.group, x)
        # bool and uint16 cross as bytes and int16 bits.
        bits = {torch.bool: torch.uint8, torch.uint16: torch.int16}.get(x.dtype, x.dtype)
        send = x.contiguous().view(bits)
        parts = [torch.empty_like(send) for _ in range(self.ranks)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts).view(x.dtype)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the E rows of x (local block (L, ...)) in index order: the
        psum of the JAX programs, with the same bits whatever the split."""
        full = self.gather(x)
        acc = full[0]
        for i in range(1, full.shape[0]):
            acc = acc + full[i]
        return acc

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """() bool: whether `flag` holds on any rank (JAX's `any_active_fn`:
        every rank then runs the same number of loop trips)."""
        if self.ranks == 1:
            return flag
        # One int32 on the side of the group's backend.
        t = flag.to(torch.int32).reshape(1)
        t = t.cuda() if dist.get_backend(self.group) == "nccl" else t.cpu()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return (t[0] > 0).to(flag.device)

    def gather_host(self, x: torch.Tensor) -> torch.Tensor:
        """`gather` of a small result read on the host (poses, counters):
        moved to the side of the group's backend first (the CPU for gloo,
        the rank's card for NCCL); returned on the CPU."""
        if self.ranks == 1:
            return x.cpu()
        nccl = dist.get_backend(self.group) == "nccl"
        return self.gather(x.cuda() if nccl else x.cpu()).cpu()


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The port's device grid: named axes over this process's `device`."""

    device: torch.device
    axes: Tuple[Tuple[str, GridAxis], ...] = ()

    @property
    def shape(self) -> dict:
        return {name: ax.extent for name, ax in self.axes}

    def axis(self, name: str) -> GridAxis:
        for n, ax in self.axes:
            if n == name:
                return ax
        raise KeyError(f"the grid has no axis {name!r} (axes {[n for n, _ in self.axes]})")


def process_axes(names: Sequence[str], rank_extents: Sequence[int],
                 local_extents: Optional[Sequence[int]] = None
                 ) -> Tuple[Tuple[str, GridAxis], ...]:
    """Axes laid row-major over the ranks of the default process group:
    axis i spans `rank_extents[i]` ranks (their product must be the world
    size) times `local_extents[i]` local rows (default 1). Every rank must
    call this with the same arguments (it makes the axes' process groups)."""
    local_extents = list(local_extents or [1] * len(names))
    n_ranks, rank = world()
    total = 1
    for r in rank_extents:
        total *= int(r)
    if total != n_ranks:
        raise ValueError(f"a {' x '.join(map(str, rank_extents))} grid of ranks needs "
                         f"{total} processes; {n_ranks} are joined (initialise "
                         "torch.distributed with that world size)")
    coords, rest = [], rank
    for r in reversed(rank_extents):
        coords.append(rest % r)
        rest //= r
    coords = coords[::-1]
    axes = []
    for i, name in enumerate(names):
        group = None
        if rank_extents[i] > 1:
            # new_group must be entered by every rank for every group, in
            # the same order.
            others = [range(r) for j, r in enumerate(rank_extents) if j != i]
            for fixed in itertools.product(*others):
                members = []
                for k in range(rank_extents[i]):
                    c = list(fixed)
                    c.insert(i, k)
                    flat = 0
                    for cj, rj in zip(c, rank_extents):
                        flat = flat * rj + cj
                    members.append(flat)
                g = (dist.group.WORLD if len(members) == n_ranks
                     else dist.new_group(members))
                if rank in members:
                    group = g
        axes.append((name, GridAxis(extent=int(rank_extents[i]) * int(local_extents[i]),
                                    ranks=int(rank_extents[i]), index=coords[i],
                                    group=group)))
    return tuple(axes)
