"""A configuration names its scan model and its reference as files, and the
harness refuses a configuration whose meaning its reference does not
model, before anything is rendered; the two span readers that nested spans
and traced frames concern. On the CPU, in a temporary checkout.

A copy of `odobench/tests/test_odobench_config_files.py` where the
repository's tests run, with (d) holding each cell to the reference its
configuration names."""

import copy
import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from odobench.harness import REPO, Layout, drive_seeds, render_drives, run_cell, unmodelled
from odobench.reference import kiss
from odobench.scans import Drive, Sensor
from odobench.tests.tiny import TINY_CONFIG, TINY_TRAFFIC, make_root
from odobench.trace import Trace

# A drive that stands still for 3 frames in its middle, and a reference that
# is plain KISS-ICP; each notes in the checkout that it was used.
HELD = '''
from pathlib import Path

import numpy as np

from odobench.harness import drive_seeds
from odobench.scans import Drive, Sensor


def render_drives(config, traffic, seed, device):
    sensor = Sensor(**config["sensor"], max_range=float(config["kiss"]["data"]["max_range"]))
    drives = []
    for row in range(int(traffic.get("rows", 1))):
        world, noise = drive_seeds(seed, row)
        drive = Drive(sensor, int(traffic["drive_frames"]), world_seed=world, noise_seed=noise,
                      device=device, **config["drive"])
        p, mid = drive.render_poses, drive.n_scans // 2
        drive.render_poses = np.concatenate([p[:mid], np.repeat(p[mid - 1:mid], 3, axis=0),
                                             p[mid:-3]])
        drives.append(drive.render())
    with open(Path(__file__).parents[2] / "used", "a") as f:
        f.write("scans\\n")
    return drives
'''
PLAIN = '''
from pathlib import Path

from odobench.reference import kiss
from odobench.reference.kiss import MODELS, Params, pose_gap


def follow(*args, **kwargs):
    with open(Path(__file__).parents[2] / "used", "a") as f:
        f.write("reference\\n")
    return kiss.follow(*args, **kwargs)
'''
# A scan model that fails if it is ever called.
NEVER = '''
def render_drives(config, traffic, seed, device):
    raise RuntimeError("rendered")
'''

REFUSED = {
    "u16": ("map_storage", "u16"),
    "cached": ("nn_mode", "cached"),
    "deskew_refine": ("deskew_refine", 1),
    "deskew_refine_map": ("deskew_refine_map", True),
    "ground_align": ("ground_align", 0.1),
    "assoc": ("assoc_cache_size", 8),
    "unknown": ("no_such_key", 1),
}
MISSING = {"no_scans": {"scans": "nowhere"}, "no_reference": {"reference": "nowhere"}}


def _config(name, **keys):
    config = copy.deepcopy(TINY_CONFIG)
    config["name"] = name
    config.update(keys)
    return config


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout with a configuration and a cell for each case."""
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("odobench"))
    (root / "odobench" / "sensors").mkdir()
    for stem, text in (("sensors/held", HELD), ("sensors/never", NEVER),
                       ("reference/plain", PLAIN)):
        (root / "odobench" / f"{stem}.py").write_text(text)
    configs = {"held": _config("held", scans="held", reference="plain")}
    for case, (key, value) in REFUSED.items():
        config = _config(case, scans="never")
        config["kiss"]["engine"][key] = value
        configs[case] = config
    configs.update({case: _config(case, **keys) for case, keys in MISSING.items()})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, config in configs.items():
        (root / "odobench" / "configs" / f"{name}.json").write_text(json.dumps(config))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"odobench/configs/{name}.json", "reduced": [],
                                 "why": "test"})
        bench["workloads"].append({"name": f"{name}.tiny_offline", "config": name,
                                   "traffic": "tiny_offline", "chips": 1, "why": "test"})
        shutil.copy(root / "odobench" / "limits" / "tiny.tiny_offline.json",
                    root / "odobench" / "limits" / f"{name}.tiny_offline.json")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, cell):
    return run_cell(cell, 2**33 + 19, 0.5, False, device="cpu", root=root,
                    log=lambda s: None)


def _run_apart(root, cell):
    """`_run` in a process of its own, which loads no JAX: this one has
    loaded it for the JAX package's tests, and a measured process may not.
    Returns the result's `correct` and `failed`."""
    code = ("import json, torch\n"
            "from pathlib import Path\n"
            "from odobench.harness import run_cell\n"
            "torch.set_num_threads(2)\n"
            f"r = run_cell({cell!r}, 2**33 + 19, 0.5, False, device='cpu', "
            f"root=Path({str(root)!r}), log=lambda s: None)\n"
            "print(json.dumps({'correct': r['correct'], 'failed': r['failed']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_configuration_brings_its_scans_and_reference(root):
    """(a) A standstill drive and a reference stem, both files of the
    checkout alone, run through `run_cell` and check as correct."""
    layout = Layout(root)
    config = layout.config("held")
    cpu = torch.device("cpu")
    held = layout.scans(config)(config, TINY_TRAFFIC["tiny_offline"], 5, cpu)[0]
    plain = render_drives(config, TINY_TRAFFIC["tiny_offline"], 5, cpu)[0]
    # The first half of the drive is the default's; the standstill's frames
    # are another scan.
    for k in range(6):
        np.testing.assert_array_equal(held[k][0], plain[k][0])
    assert held[6][0].shape != plain[6][0].shape or not np.array_equal(held[6][0], plain[6][0])
    (root / "used").unlink()
    result = _run_apart(root, "held.tiny_offline")
    assert result["correct"] is True and result["failed"] == 0
    assert set((root / "used").read_text().split()) == {"scans", "reference"}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_meaning_the_reference_does_not_model_is_refused(root, case):
    """(b) Refused before the render (the scan model would raise), the key
    named."""
    key, _ = REFUSED[case]
    with pytest.raises(SystemExit, match=rf"kiss\.engine\.{key}"):
        _run(root, f"{case}.tiny_offline")


@pytest.mark.parametrize("case", sorted(MISSING))
def test_a_missing_scan_model_or_reference_is_named(root, case):
    """(c)"""
    with pytest.raises(KeyError, match="nowhere"):
        _run(root, f"{case}.tiny_offline")


def test_layout_and_speed_keys_are_modelled():
    engine = {"map_storage": "f32", "nn_mode": "loop27", "gn_unroll": 4, "map_shards": 2,
              "deskew_refine": 0, "deskew_refine_map": False, "ground_align": 0.0,
              "pipeline_chunk": 16, "use_pallas": "auto"}
    kiss_config = dict(TINY_CONFIG["kiss"], engine=dict(TINY_CONFIG["kiss"]["engine"], **engine))
    assert unmodelled(kiss_config, kiss.MODELS) == []
    assert unmodelled({"out_dir": "results"}, kiss.MODELS) == ["kiss.out_dir"]


def test_the_repository_cells_use_the_default_scans_and_their_reference():
    """(d) Every cell renders with `odobench/scans.py`; it checks with
    `reference/<stem>.py` where its configuration says `"reference":
    "<stem>"`, else with `reference/kiss.py`, and that reference models
    every key its configuration states; the tiny sensor's scans are
    `Drive.render()`'s, bit for bit."""
    layout = Layout(REPO)
    for cell in layout.bench["workloads"]:
        config = layout.config(cell["config"])
        assert layout.scans(config) is render_drives
        ref = layout.reference(config)
        stem = config.get("reference", "kiss")
        assert ref.__file__ == str(REPO / "odobench" / "reference" / f"{stem}.py")
        assert unmodelled(config["kiss"], ref.MODELS) == []
    traffic = dict(TINY_TRAFFIC["tiny_batch"], rows=2, drive_frames=4)
    seed = 2**31 + 7
    drives = layout.scans(TINY_CONFIG)(TINY_CONFIG, traffic, seed, torch.device("cpu"))
    sensor = Sensor(**TINY_CONFIG["sensor"], max_range=100.0)
    for row in range(2):
        world, noise = drive_seeds(seed, row)
        want = Drive(sensor, 4, world_seed=world, noise_seed=noise,
                     **TINY_CONFIG["drive"]).render()
        assert len(drives[row]) == len(want)
        for (p, s), (wp, ws) in zip(drives[row], want):
            np.testing.assert_array_equal(p, wp)
            np.testing.assert_array_equal(s, ws)



def test_a_world_seed_gives_every_run_seed_the_same_worlds():
    """With `world_seed` in the traffic file, the worlds and trajectories
    are that seed's, dealt to the rows in an order the run's seed draws;
    the run's seed draws the sensor noise."""
    traffic = dict(TINY_TRAFFIC["tiny_batch"], rows=3, drive_frames=2, world_seed=2012)
    sensor = Sensor(**TINY_CONFIG["sensor"], max_range=100.0)
    orders = set()
    for seed in (2**31 + 7, 2**33 + 1, 5, 9):
        drives = render_drives(TINY_CONFIG, traffic, seed, torch.device("cpu"))
        order = []
        for row, got in enumerate(drives):
            noise = drive_seeds(seed, row)[1]
            for w in range(3):
                want = Drive(sensor, 2, world_seed=drive_seeds(2012, w)[0], noise_seed=noise,
                             device=torch.device("cpu"), **TINY_CONFIG["drive"]).render()
                if all(np.array_equal(p, wp) for (p, _), (wp, _) in zip(got, want)):
                    order.append(w)
                    break
        assert sorted(order) == [0, 1, 2]
        orders.add(tuple(order))
    assert len(orders) > 1

# Two traced frames in one call: the pack and the copy, a frame span around
# the stages, a GN trip and its reads nested in the alignment, the pose read,
# and a span of the next call that starts inside this one's end.
NESTED = Trace(spans=[
    ("odobench/dispatch_chunk", 0.0, 1000.0), ("kiss/pack", 0.0, 100.0),
    ("kiss/h2d", 100.0, 150.0), ("kiss/frame", 150.0, 900.0), ("kiss/align", 190.0, 395.0),
    ("kiss/sync/gn", 195.0, 200.0), ("kiss/gn_trip", 200.0, 260.0),
    ("kiss/sync/gn", 260.0, 300.0), ("kiss/map_insert", 400.0, 600.0),
    ("kiss/sync/poses", 900.0, 950.0), ("kiss/pack", 990.0, 1200.0)])


def _ctx(metric, trace, traced, iterations):
    return SimpleNamespace(metric=metric, trace=trace, traced=traced, iterations=iterations)


def test_wrapper_ms_counts_each_instant_once():
    """(e) Outside the `kiss/` spans: 950 to 990 us of the call, over two
    frames; never below zero."""
    read = Layout().reader("wrapper_ms.offline").read
    assert read(_ctx("wrapper_ms.offline", NESTED, [0, 1], [3, 3])) == pytest.approx(0.02)
    flat = Trace(spans=[("odobench/summary_poses", 0.0, 10.0), ("kiss/summary", 2.0, 6.0)])
    assert read(_ctx("wrapper_ms.offline", flat, [0], [3])) == pytest.approx(0.006)
    assert read(_ctx("wrapper_ms.offline", Trace(), [], [])) is None


def test_gn_iters_per_frame_reads_the_traced_frames():
    """(e) The traced calls' frames alone, not the window's."""
    read = Layout().reader("gn_iters_per_frame.offline").read
    assert read(_ctx("gn_iters_per_frame.offline", NESTED, [2, 3], [5, 7, 30, 40])) == 35.0
    assert read(_ctx("gn_iters_per_frame.offline", NESTED, [], [5, 7])) is None
