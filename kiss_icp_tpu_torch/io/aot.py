"""Ahead-of-time export of the odometry step (`torch.export`).

Port of `kiss_icp_tpu/io/aot.py`. `torch.export.export` traces
`odometry.register_frame` for one config into an `ExportedProgram`: its ATen
graph, with the ICP loop as `torch.while_loop` (the map's claim rounds
are `probe_length` plain rounds), the empty-map shortcut as `torch.cond`
(ops/control.py), and the two kernels
as the registered operators `kiss_icp_torch::linsys` (K1) and
`kiss_icp_torch::nn27` (K2). `torch.export.save` serializes it; a serving
process loads it and calls it without tracing the port's code.

Where the port differs from the JAX package: JAX's artifact is StableHLO
that any PJRT host can compile. The port's artifact is an ATen graph whose
two kernel calls are this package's operators, so the process that loads it
must import `kiss_icp_tpu_torch` (this module does, and registers them), and
the kernels are built from `csrc/` at their first launch on the card.

Format: npz with the serialized program (`exported`) and a JSON metadata
record (`metadata_json`): io/checkpoint's engine geometry, plus the format's
name and version, the padded frame size, the chunk size (0 = one frame a
call) and the device type the program was exported for. `load_step` refuses
any other format with a ValueError, an artifact of the JAX package included
(its version is also 2; its record names no `aot_format`).
"""

from __future__ import annotations

import io
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.io.checkpoint import _metadata
# Importing the kernel modules registers the two operators the program calls.
from kiss_icp_tpu_torch.kernels import linsys, nn27  # noqa: F401

AOT_FORMAT = "torch.export"
FORMAT_VERSION = 2


class _Module(torch.nn.Module):
    """A step function as the module `torch.export` takes."""

    def __init__(self, step):
        super().__init__()
        self.step = step

    def forward(self, state, points, timestamps, valid):
        return self.step(state, points, timestamps, valid)


def _export(module, config, frame_shape, device) -> bytes:
    odometry.register_pytree_types()
    dev = odometry.resolve_device(device)
    n = int(config.engine.max_points_per_frame)
    args = (odometry.init_state(config, dev),
            torch.zeros((*frame_shape, n, 3), dtype=torch.float32, device=dev),
            torch.zeros((*frame_shape, n), dtype=torch.float32, device=dev),
            torch.zeros((*frame_shape, n), dtype=torch.bool, device=dev))
    ep = torch.export.export(module, args)
    # The example inputs (a whole map) are not part of the program.
    ep._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_step(config, device=None) -> bytes:
    """Serialize the single-frame step for `config`: `step(state, points
    (N,3) f32, timestamps (N,) f32, valid (N,) bool) -> (state,
    FrameResult)`, N = engine.max_points_per_frame, exported for `device`
    (None means CUDA; the tests pass "cpu"). Returns the bytes of
    `torch.export.save`. `engine.donate_state` is frozen into the program:
    set, it updates the caller's map in place, as the live step does. As in
    the JAX package, this is the single-device step whatever
    `engine.map_shards` says (the map-sharded engine is not exported)."""
    return _export(_Module(odometry.make_step(config)), config, (), device)


def export_chunked_step(config, chunk: int, device=None) -> bytes:
    """Serialize the K-frame chunked step, `step(state, points (K,N,3),
    timestamps (K,N), valid (K,N)) -> (state, ChunkSummary)`. PyTorch has no
    `lax.scan`, so the K frames are unrolled into the program: export time
    and the program's size grow with K (`save_step` reports the time)."""
    return _export(_Module(odometry.make_chunked_step(config)), config, (int(chunk),),
                   device)


def save_step(path, config, device=None, chunk: int = 0) -> float:
    """Export and write the artifact (atomic, with the metadata record).

    `chunk` > 0 exports the K-frame chunked step instead of the per-frame
    one (`aot_chunk` in the metadata, 0 = per-frame). Returns the export's
    seconds."""
    t0 = time.perf_counter()
    if chunk > 0:
        blob = export_chunked_step(config, chunk, device=device)
    else:
        blob = export_step(config, device=device)
    seconds = time.perf_counter() - t0
    meta = dict(_metadata(config), aot_format=AOT_FORMAT,
                aot_format_version=FORMAT_VERSION,
                max_points_per_frame=int(config.engine.max_points_per_frame),
                aot_chunk=int(chunk),
                device_type=odometry.resolve_device(device).type)
    path = Path(path)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp.npz")
    np.savez_compressed(
        tmp,
        exported=np.frombuffer(blob, dtype=np.uint8),
        metadata_json=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)
    return seconds


def load_step(path):
    """Load an artifact written by `save_step`.

    Returns `(step_fn, metadata)`: `step_fn(state, points, timestamps,
    valid)` is the loaded program's module (no tracing of the port's code)
    and returns what the exported step returns; `metadata` echoes the
    engine geometry it was built for. Feed it states from
    `odometry.init_state` with the SAME geometry, on the device it was
    exported for (or a matching checkpoint). Raises ValueError for another
    format or version, an artifact of the JAX package included."""
    odometry.register_pytree_types()
    with np.load(Path(path)) as data:
        meta = json.loads(bytes(data["metadata_json"]).decode())
        if (meta.get("aot_format"), meta.get("aot_format_version")) != (
                AOT_FORMAT, FORMAT_VERSION):
            raise ValueError(
                f"AOT artifact {path} has format {meta.get('aot_format', 'unnamed')!r} "
                f"version {meta.get('aot_format_version')}, expected {AOT_FORMAT!r} "
                f"version {FORMAT_VERSION} (an artifact of the JAX package names no "
                "format: re-export it with kiss_icp_tpu_torch.io.aot)")
        blob = bytes(data["exported"])
    return torch.export.load(io.BytesIO(blob)).module(), meta
