"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is a file found by name:
  * the cell: an entry of `BENCHMARK.json`'s `workloads`, naming its
    configuration and its traffic mix;
  * the configuration: the file its entry in `configs` names (a sensor, a
    drive and a KISS-ICP `kiss` section);
  * the scan model: `odobench/sensors/<stem>.py` where the configuration
    says `"scans": "<stem>"`, whose `render_drives(config, traffic, seed,
    device)` gives each drive as host (points, stamps) arrays; without the
    key, `render_drives` below (`odobench/scans.py`);
  * the reference: `odobench/reference/<stem>.py` where the configuration
    says `"reference": "<stem>"`, `kiss.py` without the key; it exports
    `Params.from_config(kiss)`, `follow`, `pose_gap` and `MODELS`, the
    `kiss` keys and values it models, and a configuration that states any
    other is refused before anything is rendered (`unmodelled`);
  * the traffic mix: `odobench/traffic/<traffic>.json`, and the driver
    module it names, `odobench/traffic/<driver>.py`;
  * the limits of its check: `odobench/limits/<cell>.json`;
  * a metric: `odobench/end_to_end/<name>.py` for an end-to-end metric; for
    a per-layer metric `odobench/layer_metrics/<name>.py`, or for
    `<base>.<variant>` `<base>.py`, or for `<kernel>_roofline`
    `roofline.py`.
A cell, a configuration, a scan model, a reference, a traffic mix or a
metric is added by adding files and entries.

`run_cell` does the work; `odobench/run.py` is the command line, which
refuses to run without a card.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np

from odobench.window import Profiler

REPO = Path(__file__).resolve().parent.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "kiss_icp_tpu")
# A checked frame off the reference by more than this is counted.
OFF_M = 0.05


class Layout:
    """The benchmark's files under `root` (a checkout)."""

    def __init__(self, root: Path = REPO):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "odobench"

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def metrics(self, kind: str, cell: str) -> List[dict]:
        """The `end_to_end` or `per_layer` metrics this cell reports."""
        return [m for m in self.bench[kind] if "workloads" not in m or cell in m["workloads"]]

    def _module(self, folder: str, stem: str):
        path = self.dir / folder / f"{stem}.py"
        if not path.is_file():
            return None
        spec = importlib.util.spec_from_file_location(f"odobench_{folder}_{stem}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # where a dataclass looks its module up
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        """The traffic driver module `odobench/traffic/<name>.py`."""
        mod = self._module("traffic", name)
        if mod is None:
            raise KeyError(f"no traffic driver {name!r}")
        return mod

    def scans(self, config: dict) -> Callable:
        """The configuration's `render_drives`: its scan model's,
        `odobench/sensors/<stem>.py`, or this module's."""
        stem = config.get("scans")
        if stem is None:
            return render_drives
        mod = self._module("sensors", stem)
        if mod is None:
            raise KeyError(f"no scan model {stem!r} (odobench/sensors/{stem}.py)")
        return mod.render_drives

    def reference(self, config: dict):
        """The configuration's reference, `odobench/reference/<stem>.py`."""
        stem = config.get("reference", "kiss")
        mod = self._module("reference", stem)
        if mod is None:
            raise KeyError(f"no reference {stem!r} (odobench/reference/{stem}.py)")
        return mod

    def end_to_end(self, metric: str):
        mod = self._module("end_to_end", metric)
        if mod is None:
            raise KeyError(f"no reader for end-to-end metric {metric!r}")
        return mod

    def reader(self, metric: str):
        base = metric.split(".", 1)[0]
        for stem in (metric, base, base.rsplit("_", 1)[-1]):
            mod = self._module("layer_metrics", stem)
            if mod is not None:
                return mod
        raise KeyError(f"no reader for per-layer metric {metric!r}")


def unmodelled(kiss: dict, models: Dict[str, Optional[tuple]]) -> List[str]:
    """Each `kiss` key (`section.key`) of a configuration, with its value,
    that `models` (a reference's `MODELS`: the values of each key it
    models, None for any) does not hold."""
    out = []
    for section, keys in kiss.items():
        items = keys.items() if isinstance(keys, dict) else [(None, keys)]
        for key, value in items:
            name = section if key is None else f"{section}.{key}"
            if name not in models:
                out.append(f"kiss.{name}")
            elif models[name] is not None and value not in models[name]:
                out.append(f"kiss.{name}: {value!r}")
    return out


def drive_seeds(seed: int, row: int):
    """(world seed, noise seed) of drive `row` of a run's `--seed`."""
    s = int(seed) % (1 << 64)
    world = np.random.SeedSequence([s, row, 0])
    noise = int(np.random.SeedSequence([s, row, 1]).generate_state(1, np.uint64)[0]) >> 2
    return world, noise


def render_drives(config: dict, traffic: dict, seed: int, device) -> List[list]:
    """The cell's drives, rendered on `device`, as host scans. Where the
    traffic file gives a `world_seed`, the worlds and trajectories are that
    seed's, the same for every run, and the run's seed deals them to the
    rows in an order of its own and draws the sensor noise: every seed then
    asks for the same work."""
    from odobench.scans import Drive, Sensor

    kiss = config["kiss"]
    sensor = Sensor(**config["sensor"], max_range=float(kiss["data"]["max_range"]))
    rows = int(traffic.get("rows", 1))
    fixed = traffic.get("world_seed")
    if fixed is not None:
        order = np.random.default_rng([int(seed) % (1 << 64), 0x0DE1]).permutation(rows)
    drives = []
    for row in range(rows):
        world, noise = drive_seeds(seed, row)
        if fixed is not None:
            world, _ = drive_seeds(fixed, int(order[row]))
        drive = Drive(sensor, int(traffic["drive_frames"]), world_seed=world, noise_seed=noise,
                      device=device, **config["drive"])
        drives.append(drive.render())
    return drives


def choose_frames(seed: int, rec, iterations: List[int], count: int, rows: int = 1) -> List[int]:
    """Positions in the record of the frames the check registers, `count`
    split evenly over the `rows` (a drive's row is its number modulo
    `rows`): the first frame registered against a map, the one with the
    most GN iterations, the last of each drive, and in each row more drawn
    from the seed."""
    n = len(rec.frames)
    pos = [i for i in range(n) if rec.frames[i][1] > 0]
    if not pos:
        return []
    chosen = {pos[0], max(pos, key=lambda i: iterations[i])}
    last: Dict[int, int] = {}
    for i in pos:
        last[rec.frames[i][0]] = i
    chosen |= set(last.values())
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x0DD0])
    for row in range(rows):
        mine = [i for i in pos if rec.frames[i][0] % rows == row]
        have = sum(1 for i in chosen if rec.frames[i][0] % rows == row)
        rest = sorted(set(mine) - chosen)
        take = max(0, min(len(rest), count // rows - have))
        if take:
            chosen |= set(int(i) for i in rng.choice(rest, size=take, replace=False))
    return sorted(chosen)


def check(ref, params, drives, rec, positions: List[int], device, work_positions=()):
    """Follow each drive the window ran with the reference module `ref`,
    register the chosen frames, and compare. Returns (largest pose gap in
    metres, {record position: work records}, [(position, gap, reference
    iterations)])."""
    rows = len(drives)
    by_drive: Dict[int, List[int]] = {}
    for i, (d, _) in enumerate(rec.frames):
        by_drive.setdefault(d, []).append(i)
    want = set(positions) | set(work_positions)
    gap, work, frames = 0.0, {}, []
    for d, members in by_drive.items():
        mine = [i for i in members if i in want]
        if not mine:
            continue
        poses = np.stack([rec.poses[i] for i in members]).astype(np.float64)
        idx = {rec.frames[i][1]: i for i in members}
        out = ref.follow(params, drives[d % rows], poses, [rec.frames[i][1] for i in mine],
                         device=device, record_work=bool(work_positions))
        for k, (ref_pose, ref_iters, works) in out.items():
            i = idx[k]
            if i in positions:
                g = ref.pose_gap(params, ref_pose, rec.poses[i])
                g = g if math.isfinite(g) else float("inf")
                gap = max(gap, g)
                frames.append((i, g, ref_iters))
            if i in work_positions:
                work[i] = works
    return gap, work, frames


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def clocks_line() -> str:
    """The card's SM clock (now and its maximum), power draw and
    temperature, and the mean clock of the host cores this process may run
    on: read once as the window closes, so that a run's rate can be set
    beside the clocks it ran at."""
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "nvidia-smi unavailable"
    mhz = []
    for core in sorted(os.sched_getaffinity(0)):
        try:
            khz = Path(f"/sys/devices/system/cpu/cpu{core}/cpufreq/scaling_cur_freq").read_text()
            mhz.append(int(khz) / 1e3)
        except (OSError, ValueError):
            pass
    if not mhz:
        try:
            mhz = [float(line.split(":")[1]) for line in
                   Path("/proc/cpuinfo").read_text().splitlines() if line.startswith("cpu MHz")]
        except (OSError, ValueError, IndexError):
            pass
    host = f"{sum(mhz) / len(mhz):.0f} MHz" if mhz else "unread"
    return (f"card sm clock, max, power, temperature: {card}; host cores "
            f"{sorted(os.sched_getaffinity(0))} at {host}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device,
             t_start: Optional[float] = None, root: Path = REPO,
             system_factory: Optional[Callable] = None, log=print,
             check_frames: Optional[int] = None, details: Optional[dict] = None) -> dict:
    """One run of `workload`. Returns the result object; `log` gets the
    lines that come before it. `check_frames` overrides how many frames
    the check registers (odobench/calibrate.py)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    layout = Layout(root)
    cell = layout.cell(workload)
    config = layout.config(cell["config"])
    traffic = layout.traffic(cell["traffic"])
    limits = layout.limits(workload)
    rows = int(traffic.get("rows", 1))
    dev = torch.device(device)
    # A meaning the reference does not model would be checked as plain
    # KISS-ICP: refused before anything runs.
    ref = layout.reference(config)
    refused = unmodelled(config["kiss"], ref.MODELS)
    if refused:
        raise SystemExit(f"odobench: {cell['config']}: reference/{Path(ref.__file__).name} "
                         "does not model " + ", ".join(refused))

    # Set-up: scans on the card, the program, every call shape warmed.
    t_render = time.perf_counter()
    drives = layout.scans(config)(config, traffic, seed, dev)
    render_s = time.perf_counter() - t_render
    if system_factory is None:
        from odobench.program import Port as system_factory
    system = system_factory(config["kiss"], dev, rows=rows)
    driver = layout.driver(traffic["driver"])
    driver.warm_up(system, drives, traffic)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    # The window.
    trace_calls = traffic["trace_calls"] if trace else (0, 0)
    prof = Profiler(*trace_calls)
    rec = driver.run(system, drives, traffic, seconds, prof)
    clocks = clocks_line() if dev.type == "cuda" else "cpu"
    iterations = system.iterations()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace_data = None
    if trace:
        from odobench.trace import reduce_events

        trace_data = reduce_events(prof.events or [])
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The check, after the window, on the card.
    params = ref.Params.from_config(config["kiss"])
    count = int(traffic["check_frames"]) if check_frames is None else int(check_frames)
    positions = choose_frames(seed, rec, iterations, count, rows)
    layer = layout.metrics("per_layer", workload) if trace else []
    readers = {m["name"]: layout.reader(m["name"]) for m in layer}
    traced = rec.traced_frames() if trace else []
    wants_work = any(getattr(r, "NEEDS_WORK", False) for r in readers.values())
    t_check = time.perf_counter()
    gap, work, checked = check(ref, params, drives, rec, positions, dev,
                               work_positions=traced if wants_work else ())
    check_s = time.perf_counter() - t_check
    failed = sum(1 for p in rec.poses if not np.all(np.isfinite(p)))
    # The median over the checked frames holds every frame to the
    # reference; a few frames of any drive sit where ICP's answer is not
    # determined to a millimetre (PERF.md), so their gaps swing from run to
    # run, also between two float32 paths. The share of checked frames off
    # by more than 5 cm holds a fault that hits fewer than half of them:
    # some rows of the batch, every other frame of a call.
    gaps = np.asarray([g for _, g, _ in checked], np.float64)
    median = float(np.median(gaps)) if gaps.size else float("inf")
    over = 100.0 * float(np.mean(gaps > OFF_M)) if gaps.size else 100.0
    checks = {"pose_gap_median_m": {"value": median,
                                    "limit": float(limits["pose_gap_median_m"])},
              "frames_over_5cm_pct": {"value": over,
                                      "limit": float(limits["frames_over_5cm_pct"])},
              "failed_frames": {"value": failed, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    metrics: Dict[str, dict] = {}
    result = {"correct": bool(correct), "attempted": len(rec.frames), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        for m in layer:
            ctx = SimpleNamespace(metric=m["name"], trace=trace_data, iterations=iterations,
                                  traced=traced, work=work)
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info["busy_s"] = trace_data.busy_us() / 1e6
        device_info["window_s"] = trace_data.window_us() / 1e6
        result["breakdown"] = {"device_ops": trace_data.top_device_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    else:
        ctx = SimpleNamespace(rec=rec, setup_s=setup_s)
        for m in layout.metrics("end_to_end", workload):
            value = layout.end_to_end(m["name"]).read(ctx)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["checks"] = checks
    result_details = {"checked": [(rec.frames[i][0], rec.frames[i][1], g, iterations[i], r)
                                  for i, g, r in checked], "iterations": iterations}

    iters = np.asarray(iterations, np.float64)
    log(f"odobench: {workload} seed {seed}: {len(rec.frames)} frames in {rec.window_s:.3f} s "
        f"({len(rec.call_frames)} calls), setup {setup_s:.3f} s (render {render_s:.3f} s), "
        f"check {check_s:.3f} s, GN iterations a frame "
        f"mean {iters.mean() if iters.size else 0:.2f} max {iters.max() if iters.size else 0:.0f}, "
        f"{len(positions)} frames checked; {card_line() if dev.type == 'cuda' else 'cpu'}")
    log(f"odobench: at the window's close, {clocks}")
    worst = sorted(checked, key=lambda c: -c[1])[:5]
    log(f"odobench: largest gap {gap:.3e} m, {int(np.sum(gaps > OFF_M))} of {gaps.size} "
        "checked frames over 5 cm; the five largest (drive, frame, gap m, "
        "GN iterations program / reference): "
        + "; ".join(f"{rec.frames[i][0]} {rec.frames[i][1]} {g:.3e} {iterations[i]} / {r}"
                    for i, g, r in worst))
    if details is not None:
        details.update(result_details)
    # What the port loaded into this process, up to the result.
    banned = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))
    if banned:
        raise SystemExit(f"odobench: the measured process loaded {', '.join(banned)}")
    return result


def emit(result: dict, out=None, err=None) -> None:
    """The compared numbers as the last lines of stderr, the result as the
    last line of stdout."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()

