"""A benchmark at a size the CPU holds, in a temporary checkout: the
repository's BENCHMARK.json with two more cells on a tiny sensor and map,
its files copied beside it (the harness finds them by name)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from odobench.harness import REPO

TINY_KISS = {
    "data": {"deskew": True, "max_range": 100.0, "min_range": 1.0},
    "mapping": {"voxel_size": 1.0, "max_points_per_voxel": 20},
    "adaptive_threshold": {"initial_threshold": 2.0, "min_motion_th": 0.1},
    "registration": {"max_num_iterations": 500, "convergence_criterion": 0.0001},
    "engine": {"max_points_per_frame": 8192, "frame_capacity": 4096, "source_capacity": 1024,
               "map_capacity_log2": 14, "probe_length": 16, "group_capacity": 16},
}
TINY_CONFIG = {"name": "tiny", "source": "test", "reduced": [],
               "sensor": {"n_beams": 24, "n_azimuth": 384, "elevation_deg": [-24.0, 2.0],
                          "distort": True, "noise": 0.01, "dropout": 0.2},
               "drive": {"speed": 1.0, "accel_frames": 6, "turn_rate": 0.02},
               "kiss": TINY_KISS}
TINY_TRAFFIC = {
    "tiny_offline": {"driver": "chunked", "chunk": 3, "drive_frames": 12, "warmup_calls": 1,
                     "trace_calls": [0, 1], "check_frames": 6},
    "tiny_batch": {"driver": "lockstep", "rows": 5, "drive_frames": 8, "warmup_calls": 1,
                   "trace_calls": [1, 1], "check_frames": 10},
}
# Each tiny cell is held to the limits of the repository's cell of its
# driver (read from their files at test time).
LIMITS_OF = {"chunked": "ouster64-10hz.offline", "lockstep": "hdl64e-kitti.batch11"}


def make_root(tmp: Path) -> Path:
    """A checkout holding BENCHMARK.json and odobench/, with the tiny cells."""
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "odobench", root / "odobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "odobench" / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    bench["configs"].append({"name": "tiny", "source": "test", "file": "odobench/configs/tiny.json",
                             "reduced": [], "why": "a CPU-sized sensor"})
    for name, traffic in TINY_TRAFFIC.items():
        (root / "odobench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        cell = f"tiny.{name}"
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": name, "chips": 1,
                                   "why": "test"})
        limits = REPO / "odobench" / "limits" / f"{LIMITS_OF[traffic['driver']]}.json"
        shutil.copy(limits, root / "odobench" / "limits" / f"{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and m.get("moves", m["name"]) == "frames_per_s":
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
