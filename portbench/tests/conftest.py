"""CPU tests of the benchmark's harness and reference; the card tests are
marked ``card`` and skip without a CUDA device.

    python -m pytest portbench/tests -q
"""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; run on the card, skipped elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_config(name: str) -> dict:
    """A configuration file's content at tiny widths and depths (the card
    runs the published ones)."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    m = cfg["run"]["model"]
    m.update(num_query=32, num_points=256, center_num=[32, 16], global_feature_dim=64)
    for key in ("encoder_config", "decoder_config"):
        m[key].update(embed_dim=32, num_heads=2, depth=2, k=4)
    m["encoder_config"]["block_style_list"] = ["attn-graph", "attn"]
    m["decoder_config"]["self_attn_block_style_list"] = ["attn-graph", "attn"]
    m["decoder_config"]["cross_attn_block_style_list"] = ["attn-graph", "attn"]
    return cfg


def tiny_traffic(name: str) -> dict:
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    t = copy.deepcopy(t)
    if t["kind"] == "serve":
        t.update(batch=2, pool=3, n_partial=256, n_gt=256, warmup=1, checked_requests=2)
        t["arrival"]["rate_per_s"] = 4.0
    elif t["source"] == "disk":
        t.update(batch=2)
        t["tree"] = {"taxonomies": {"02691156": 3, "03001627": 3}, "partial_points": [100, 300], "seed": 5}
        t["dataset"].update(N_POINTS=256, N_RENDERINGS=2)
        t["loader"] = {"num_workers": 2, "worker_mode": "thread"}
    else:
        t.update(batch=2, pool=8, n_gt=256, n_partial=256)
    return t


def tiny_cell(workload: str, tmp_path=None):
    """The harness's cell of ``workload`` at tiny sizes, its limits the
    cell's own. A cell that ``BENCHMARK.json`` does not list yet (the disk
    training cell, PERF.md §7) is read from its files, named
    ``<config>.<traffic>``."""
    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {w["name"]: w for w in bench["workloads"]}
    if workload in listed:
        cell = harness.Cell(ROOT, workload)
        config, traffic = listed[workload]["config"], listed[workload]["traffic"]
    else:
        config, traffic = workload.split(".", 1)
        cell = harness.Cell.__new__(harness.Cell)
        cell.name, cell.chips, cell.cache_dir = workload, 1, str(ROOT / harness.CACHE)
        spec = json.loads((ROOT / "portbench" / "limits" / f"{workload}.json").read_text())
        cell.limits, cell.not_compared = spec["limits"], spec.get("not_compared", {})
        cell.end_to_end = cell.per_layer = []
    cell.config = tiny_config(config)
    cell.traffic = tiny_traffic(traffic)
    if tmp_path is not None:
        cell.cache_dir = str(tmp_path)
    return cell
