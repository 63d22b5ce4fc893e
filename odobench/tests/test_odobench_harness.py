"""The harness against the benchmark's contract, on the CPU: cells,
configurations, traffic mixes and metrics found by name, the shape of a
run's last line, no fall-back to the CPU, and the names and units."""

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from odobench.harness import REPO, Layout, emit, run_cell
from odobench.tests.tiny import TINY_TRAFFIC, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("odobench"))
    # A per-layer metric, an end-to-end metric and a traffic driver of its
    # own, each found by its file's name.
    (root / "odobench" / "layer_metrics" / "traced_frames.py").write_text(
        "def read(ctx):\n    return len(ctx.traced) or None\n")
    (root / "odobench" / "end_to_end" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.rec.call_frames) / ctx.rec.window_s\n")
    (root / "odobench" / "traffic" / "single.py").write_text(
        "from odobench.traffic import chunked\n"
        "warm_up = chunked.warm_up\n"
        "def run(system, drives, traffic, seconds, prof):\n"
        "    return chunked.run(system, drives, dict(traffic, chunk=1), seconds, prof)\n")
    traffic = dict(TINY_TRAFFIC["tiny_offline"], driver="single")
    (root / "odobench" / "traffic" / "tiny_single.json").write_text(json.dumps(traffic))
    shutil.copy(root / "odobench" / "limits" / "tiny.tiny_offline.json",
                root / "odobench" / "limits" / "tiny.tiny_single.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.tiny_single", "config": "tiny",
                               "traffic": "tiny_single", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny.tiny_single")
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.tiny_single"]})
    bench["per_layer"].append({"name": "traced_frames.tiny", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "host wrapper", "moves": "frames_per_s",
                               "workloads": ["tiny.tiny_offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _last_line(result, capsys):
    emit(result)
    out, err = capsys.readouterr()
    assert err.strip().splitlines()[-1].startswith("check ")
    return json.loads(out.strip().splitlines()[-1])


def test_a_cell_added_as_files_runs(root, capsys):
    """Config, traffic mix, limits and cell exist only in the temporary
    checkout; the untraced run reports the cell's end-to-end metrics."""
    line = _last_line(run_cell("tiny.tiny_offline", 2**33 + 1, 0.5, False, device="cpu",
                               root=root, log=lambda s: None), capsys)
    assert list(line) == RESULT_KEYS + ["checks"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    assert set(line["checks"]) == {"pose_gap_median_m", "frames_over_5cm_pct", "failed_frames"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_metric_added_as_a_file_is_read(root, capsys):
    line = _last_line(run_cell("tiny.tiny_offline", 5, 0.5, True, device="cpu", root=root,
                               log=lambda s: None), capsys)
    assert list(line) == RESULT_KEYS + ["breakdown", "checks"]
    assert line["metrics"]["traced_frames.tiny"]["value"] == 3.0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # Span readers find the port's stages; device readers find nothing on
    # the CPU and are left out.
    assert "align_ms.offline" in line["metrics"]
    assert "k2_roofline.offline" not in line["metrics"]


@pytest.mark.parametrize("cell", ["tiny.tiny_batch", "tiny.tiny_single"])
def test_every_traffic_driver_runs(root, cell, capsys):
    """The lockstep driver, and a driver and an end-to-end metric that
    exist only as files of the temporary checkout."""
    # 2 s: a second lockstep call even on a loaded CPU (frame 0 is not checked).
    line = _last_line(run_cell(cell, 9, 2.0, False, device="cpu", root=root,
                               log=lambda s: None), capsys)
    want = {"frames_per_s", "setup_s"} | ({"calls_per_s"} if "single" in cell else set())
    assert set(line["metrics"]) == want and line["correct"] is True


def _run(cwd, *extra_env):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(cwd)}
    return subprocess.run([sys.executable, "-m", "odobench.run", "--workload",
                           "ouster64-10hz.offline", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_exits_without_a_result():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "odobench", tmp_path / "odobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_benchmark_json_names_units_and_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    layout = Layout(REPO)
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert layout.config(c["name"])["kiss"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert layout.driver(layout.traffic(w["traffic"])["driver"]).run
        assert set(layout.limits(w["name"])) == {"pose_gap_median_m", "frames_over_5cm_pct"}
        reported = {m["name"] for m in layout.metrics("end_to_end", w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert layout.metrics("per_layer", w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert layout.end_to_end(m["name"]).read
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and layout.reader(m["name"])
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in layout.metrics("end_to_end", cell)}


def test_a_process_that_loaded_jax_gives_no_result(root, monkeypatch):
    """Compared by whole top-level name: `kiss_icp_tpu_torch` is the program,
    `kiss_icp_tpu` (or jax) in the process refuses the run."""
    import types

    monkeypatch.setitem(sys.modules, "kiss_icp_tpu.ops", types.ModuleType("kiss_icp_tpu.ops"))
    with pytest.raises(SystemExit, match="kiss_icp_tpu"):
        run_cell("tiny.tiny_offline", 3, 0.2, False, device="cpu", root=root,
                 log=lambda s: None)
