"""The harness's contract on the CPU: what the command loads, what the
reference loads, cells found by name from new files alone, and the shape
of ``BENCHMARK.json``."""

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "imgadapointr_tpu", "chip_smoke")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _python(code: str, cwd=ROOT) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_traced_run_loads_no_jax_package():
    """A whole traced run at tiny sizes on the CPU, then every loaded
    module's top-level name, compared whole."""
    out = _python('''
        import argparse, json, sys, importlib.util
        sys.path[:0] = ["portbench/tests", "."]
        import torch
        from conftest import tiny_cell
        from portbench import harness
        spec = importlib.util.spec_from_file_location("pb_run", "portbench/run.py")
        run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
        cell = tiny_cell("imgencsegdec_pcn.serve_b32")
        run.measure(cell, argparse.Namespace(seed=5, seconds=0.5, trace=1), "cpu", harness, torch.device("cpu"))
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    ''')
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "imgadapointr_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    out = _python('''
        import json, sys
        import portbench.reference.models, portbench.reference.ops, portbench.reference.optim
        import portbench.reference.data, portbench.reference.flops, portbench.reference.bounds
        import portbench.reference.profile
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    ''')
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & set(FORBIDDEN + ("imgadapointr_tpu_torch",))


@pytest.mark.parametrize("name,stops", [("jax", True), ("flax.linen", True), ("imgadapointr_tpu.ops", True),
                                        ("imgadapointr_tpu_torch.ops", False), ("jaxtyping", False)])
def test_the_guard_compares_whole_top_level_names(monkeypatch, name, stops):
    from portbench import harness

    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    if stops:
        with pytest.raises(SystemExit) as e:
            harness.jax_guard()
        assert e.value.code == 3
    else:
        harness.jax_guard()


def test_a_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A scratch copy gains a configuration of a new model, a traffic mix of
    a new kind, per-layer metrics and a cell as new files and entries; no
    file already there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "adapointr_pcn.json").read_text())
    cfg["run"]["model"].update(num_query=256, NAME="NewNet")
    (pb / "configs" / "new_model.json").write_text(json.dumps(cfg))
    (pb / "reference" / "nets" / "NewNet.py").write_text(
        "from .AdaPoinTr import build, sample, step_flops  # noqa: F401\nINPUTS = ('partial', 'depth')\n")
    (pb / "kinds" / "newkind.py").write_text(
        "from ..workloads import Run\n\n\nclass NewKind(Run):\n    pass\n\n\nKIND = NewKind\n")
    traffic = json.loads((pb / "traffic" / "train_b16_mem.json").read_text())
    (pb / "traffic" / "train_b8_new.json").write_text(json.dumps(dict(traffic, batch=8, kind="newkind")))
    (pb / "metrics" / "new_metric.train.py").write_text("def read(r):\n    return 42.0 + r.units\n")
    (pb / "metrics" / "new_base.py").write_text("def read(r):\n    return 7.0 * r.units\n")
    bench["configs"].append({"name": "new_model", "source": "https://example.org/new", "file":
                             "portbench/configs/new_model.json", "reduced": [], "why": "a new one"})
    bench["workloads"].append({"name": "new_model.train_b8", "config": "new_model", "traffic": "train_b8_new",
                               "chips": 1, "why": "a new cell"})
    for metric in ("new_metric.train", "new_base.train"):
        bench["per_layer"].append({"name": metric, "unit": "%", "better": "higher", "source": "device_trace",
                                   "layer": "Device", "moves": "train_clouds_per_s", "workloads": ["new_model.train_b8"]})
    bench["end_to_end"][0]["workloads"].append("new_model.train_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python('''
        import json, sys, types
        sys.path.insert(0, ".")
        from pathlib import Path
        from portbench import harness, workloads
        cell = harness.Cell(Path("."), "new_model.train_b8")
        r = types.SimpleNamespace(units=1)
        run = workloads.make(cell, 1, None, harness.Spans())
        print(json.dumps([harness.__file__, type(run).__name__, run.inputs, run.net.__file__,
                          cell.config["run"]["model"]["num_query"], cell.traffic["batch"],
                          [m["name"] for m in cell.per_layer], [m["name"] for m in cell.end_to_end],
                          [harness.load_reader(m["name"])(r) for m in cell.per_layer]]))
    ''', cwd=tmp_path)
    path, kind, inputs, net, nq, batch, per_layer, e2e, values = json.loads(out.strip().splitlines()[-1])
    assert path.startswith(str(tmp_path)) and net.startswith(str(tmp_path))
    assert (kind, inputs) == ("NewKind", ["partial", "depth"])
    assert (nq, batch, values) == (256, 8, [43.0, 7.0])
    assert per_layer == ["new_metric.train", "new_base.train"]
    assert e2e == ["train_clouds_per_s", "setup_s"]


def test_benchmark_json_keeps_its_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        metrics = ROOT / "portbench" / "metrics"
        assert (metrics / f"{m['name']}.py").is_file() or (metrics / f"{m['name'].split('.')[0]}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells and cell in moved.get("workloads", cells)
    for cell in cells:  # setup_s, one other end-to-end metric and one per-layer metric everywhere
        reported = [m for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
