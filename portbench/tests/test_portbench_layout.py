"""The harness's contract with its checkout: what it imports, what its last
line holds, and that every cell, configuration, mix and metric is a file
found by its name."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench
from portbench.tests.conftest import SEED

HERE = Path(bench.HERE)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = _top_level_imports(path) & set(bench.FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "defslam_tpu_torch" not in _top_level_imports(path), path


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole small run on the CPU in a fresh process: afterwards no loaded
    module's top-level name is JAX's or the JAX package's (compared whole:
    ``defslam_tpu_torch`` is not ``defslam_tpu``)."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import bench\n"
        "from portbench.tests.conftest import TINY, TINY_MIX\n"
        "bench.run_cell('stereo0_localize', %d, 2.0, False, device='cpu',\n"
        "               config_overrides=TINY, mix_overrides=TINY_MIX)\n"
        "print(json.dumps({'forbidden': bench.forbidden_modules(),\n"
        "                  'port': 'defslam_tpu_torch.system' in sys.modules}))\n"
    ) % (str(bench.ROOT), SEED)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"forbidden": [], "port": True}


def test_the_last_line_holds_the_contracts_keys(tiny):
    out, samples = bench.run_cell("rigid_stream", SEED, 3.0, False, **tiny)
    line = json.loads(bench.result_line(out))
    assert list(line) == KEYS + ["compared"]
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(n) == {"value", "limit"} for n in line["compared"].values())
    assert line["attempted"] == samples["window_frames"] > 0


@pytest.mark.cuda
def test_a_traced_line_carries_the_breakdown(card):
    out, _ = bench.run_cell("stereo0_localize", SEED, 10.0, True)
    line = json.loads(bench.result_line(out))
    assert list(line) == KEYS + ["breakdown", "compared"]
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 0 < len(line["breakdown"]["device_ops"]) <= 10


def test_without_a_card_it_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "stereo0_stream",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=bench.ROOT, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_cells_configurations_mixes_and_metrics_are_found_by_name():
    b = bench.load_benchmark()
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = bench.load_data("configs", c["name"])
        assert data["reduced"] == c["reduced"]
        assert data["system"] in ("deformable", "rigid")
    for w in b["workloads"]:
        assert bench.cell_entry(b, w["name"]) is w
        bench.load_data("configs", w["config"])
        mix = bench.load_data("traffic", w["traffic"])
        assert {"n_frames", "warmup_frames", "trace_frames", "check_frames"} <= set(mix)
        assert bench.load_data("limits", w["name"])
        layer = bench.cell_metrics(b, w["name"], True)
        assert layer, w["name"]
        e2e = [m["name"] for m in bench.cell_metrics(b, w["name"], False)]
        # frame_ms_p95 spreads too widely for a bound in stereo0_stream
        # (PERF.md): read there per layer, as traced_frame_ms_p95
        assert e2e == (["frames_per_s", "setup_s"] if w["name"] == "stereo0_stream"
                       else ["frames_per_s", "frame_ms_p95", "setup_s"])
        # every per-layer metric of a cell moves an end-to-end one the cell reports
        assert all(m["moves"] in e2e for m in layer), w["name"]
    for m in b["per_layer"]:
        mod = bench.metric_module(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert callable(mod.read)


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    """A metric file dropped into ``metrics/`` is read by its name, with
    nothing else edited."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "frames_traced.py").write_text(
        'LAYER = "device"\nUNIT = "count"\nMOVES = "frames_per_s"\n'
        "def read(rec):\n    return rec.frames or None\n")
    monkeypatch.setattr(bench, "HERE", tmp_path)
    mod = bench.metric_module("frames_traced")
    assert mod.read(bench.Records(cell="x", frames=12)) == 12
    assert mod.read(bench.Records(cell="x")) is None
