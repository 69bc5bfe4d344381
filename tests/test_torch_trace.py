"""The port's spans and counters (``imgadapointr_tpu_torch/utils/trace.py``)
on the CPU, at the tiny widths of ``AdaPoinTr-tiny.yaml`` and
``ImgEncSegDec-tiny.yaml`` (64x64 images).

- With no profiler recording, a train step and a ``predict`` record nothing
  and never reach ``record_function`` or a CUDA event.
- Under ``torch.profiler``, one train step and one ``predict`` record the
  stage tree once, with the right parents and units, each span starting
  where the profiler's own annotation of it starts (one clock).
- The profiler and the spans change no number: losses, gradients, the
  updated weights and AdamW's state are bit-equal with it on and off.
- The readers of ``total_ms`` and the benchmark's nine per-layer readers
  (``portbench/metrics``) on hand-built records, and None with none.
- The loader's counters over one epoch with 2 decode threads and with none.
"""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imgadapointr_tpu_torch.datasets import DATASETS
from imgadapointr_tpu_torch.datasets.loader import LOADER_COUNTERS, Loader
from imgadapointr_tpu_torch.tools.runner import Runner
from imgadapointr_tpu_torch.utils import trace
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from portbench import harness
from test_torch_data import pcn_config, pcn_root  # noqa: F401  (a fixture)
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

CONFIGS = {"flagship": "cfgs/PCN_models/AdaPoinTr-tiny.yaml",
           "superset": "cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml"}
B, N_IN, IMG = 2, 256, 64
MODEL = {"flagship": ["model.grouper", "model.encoder", "model.query", "model.decoder", "model.head"],
         "superset": ["branch.image_encoder", "model.grouper", "model.encoder", "branch.img_fusion", "model.query",
                      "model.decoder", "branch.gdanet", "branch.seg_fusion", "model.head"]}


def runner(which: str, seed: int = 0) -> Runner:
    cfg = cfg_from_yaml_file(CONFIGS[which])
    cfg.model.img_size = IMG
    r = Runner(types.SimpleNamespace(device="cpu", seed=seed), cfg, logger="silent")
    r.make_train_state(4)
    return r


def batch(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"partial": torch.randn(B, N_IN, 3, generator=g) * 0.3, "gt": torch.randn(B, 1024, 3, generator=g) * 0.3,
            "img": torch.rand(B, IMG, IMG, 3, generator=g), "cls_vec": torch.eye(16)[[3, 11]]}


def tree(which: str) -> list:
    """(name, parent's name, unit) of a first train step, then a first predict."""
    step = [("runner.train_step", None), ("runner.augment", "runner.train_step"),
            ("runner.forward", "runner.train_step")]
    step += [(n, "runner.forward") for n in MODEL[which]]
    step += [(n, "runner.train_step") for n in ("runner.loss", "runner.backward", "runner.clip", "runner.optimizer")]
    serve = [("runner.predict", None)] + [(n, "runner.predict") for n in MODEL[which]]
    return [(n, p, 0) for n, p in step + serve]


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_spans_record_nothing_without_a_profiler(which, monkeypatch, one_torch_thread):
    """``record_function`` raises for the port's names (torch's optimizer
    opens a range of its own on every step), a CUDA event for any."""
    record_function = torch.autograd.profiler.record_function

    def refuse_ours(name, *a, **k):
        if name.split(".")[0] in ("runner", "model", "branch"):
            raise AssertionError(f"{name}: record_function with no profiler recording")
        return record_function(name, *a, **k)

    def refuse(*a, **k):
        raise AssertionError("a CUDA event with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse_ours)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    r = runner(which)
    r.train_step(batch(), 0.0)
    r.predict(batch())
    assert trace.records() == [] and trace.intervals() == [] and trace.total_ms(["runner.forward"]) is None


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_a_profiled_step_records_the_stage_tree_once_on_the_profilers_clock(which, one_torch_thread):
    r = runner(which)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.train_step(batch(), 0.0)
        r.predict(batch())
    recs = trace.records()
    got = [(x.name, None if x.parent is None else recs[x.parent].name, x.unit) for x in recs]
    assert got == tree(which)
    for x in recs:
        assert x.end_ns > x.start_ns and x.host_ms >= x.self_host_ms >= 0
        assert x.device_ms is None  # no CUDA events on the CPU
        if x.parent is not None:
            p = recs[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns
    step = recs[0]
    children = sum(x.host_ms for x in recs if x.parent == 0)
    assert step.self_host_ms == pytest.approx(step.host_ms - children)
    annotations: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            annotations.setdefault(e.name(), []).append(e.start_ns())
    for name in {x.name for x in recs}:
        mine = [x.start_ns for x in recs if x.name == name]
        theirs = sorted(annotations[name])
        assert len(theirs) == len(mine), name
        for a, b in zip(mine, theirs):
            assert abs(a - b) < 500_000, (name, a - b)
    assert trace.intervals() == [(x.start_ns, x.end_ns, x.name) for x in recs]
    assert trace.total_ms(["runner.train_step", "runner.forward"]) == step.host_ms
    assert trace.total_ms(["runner.forward"], "device") is None
    assert "runner.train_step" in trace.table()


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_the_profiler_changes_no_number(which, one_torch_thread):
    """Two runners from one seed, one step each, the second under the
    profiler: every loss, gradient, weight and AdamW moment bit-equal."""
    plain, traced = runner(which), runner(which)
    out_plain = plain.train_step(batch(1), 0.25)
    with profile(activities=[ProfilerActivity.CPU]):
        out_traced = traced.train_step(batch(1), 0.25)
    assert trace.records()
    for k in out_plain:
        assert torch.equal(torch.as_tensor(out_plain[k]), torch.as_tensor(out_traced[k])), k
    for (n, a), (_, b) in zip(plain.model.named_parameters(), traced.model.named_parameters()):
        assert torch.equal(a, b), n
        assert (a.grad is None) == (b.grad is None) and (a.grad is None or torch.equal(a.grad, b.grad)), n
    for (n, a), (_, b) in zip(plain.model.named_buffers(), traced.model.named_buffers()):
        assert torch.equal(a, b), n
    sa, sb = plain.optimizer.state_dict()["state"], traced.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(sa[i][f], sb[i][f]) for i in sa for f in sa[i])


def _records(device: bool) -> list:
    """Two train steps and two requests of hand-built spans: each step's
    forward 10 ms (a grouper of 3 inside), loss 2, backward 20, clip 1,
    optimizer 4 on the host, twice that on the device; each request's
    grouper 1, encoder 2, decoder 3, head 4, image encoder 5, GDANet 6,
    fusions 7 and 8 on the device, half of that on the host."""
    R = trace.Record
    out = []

    def add(name, parent, unit, host, dev):
        start = 1000 + len(out)
        out.append(R(start, start + int(host * 1e6), name, parent, unit, host, host, dev if device else None,
                     dev if device else None))
        return len(out) - 1

    for u in range(2):
        top = add("runner.train_step", None, u, 100.0, 200.0)
        fwd = add("runner.forward", top, u, 10.0, 20.0)
        add("model.grouper", fwd, u, 3.0, 6.0)
        for name, ms in (("runner.loss", 2.0), ("runner.backward", 20.0), ("runner.clip", 1.0),
                         ("runner.optimizer", 4.0)):
            add(name, top, u, ms, 2 * ms)
    for u in range(2):
        top = add("runner.predict", None, u, 50.0, 100.0)
        for name, ms in (("model.grouper", 1.0), ("model.encoder", 2.0), ("model.decoder", 3.0),
                         ("model.head", 4.0), ("branch.image_encoder", 5.0), ("branch.gdanet", 6.0),
                         ("branch.img_fusion", 7.0), ("branch.seg_fusion", 8.0)):
            add(name, top, u, ms / 2, ms)
    return out


# the nine readers, each with its value a unit on _records (4 units: 2 steps and 2 requests)
READINGS = {"forward_host_ms.train": 2 * 12.0 / 4, "backward_host_ms.train": 2 * 20.0 / 4,
            "optimizer_host_ms.train": 2 * 5.0 / 4, "optimizer_ms.train": 2 * 10.0 / 4,
            "branches_ms.serve_tail": 2 * 26.0 / 4, "grouper_ms.serve": 2 * (6.0 + 1.0) / 4,
            "encoder_ms.serve": 2 * 2.0 / 4, "decoder_ms.serve": 2 * 3.0 / 4, "head_ms.serve": 2 * 4.0 / 4}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_the_benchmarks_span_readers(metric, monkeypatch):
    read = harness.load_reader(metric)
    r = types.SimpleNamespace(units=4)
    assert read(r) is None  # no spans recorded
    monkeypatch.setattr(trace, "records", lambda: _records(device=True))
    assert read(r) == pytest.approx(READINGS[metric])
    assert read(types.SimpleNamespace(units=0)) is None
    monkeypatch.setattr(trace, "records", lambda: _records(device=False))
    on_the_host = metric.split(".")[0] in ("forward_host_ms", "backward_host_ms", "optimizer_host_ms")
    assert (read(r) is not None) == on_the_host  # no device clock without CUDA events


def test_total_ms_takes_the_outermost_named_spans(monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: _records(device=True))
    assert trace.total_ms(["runner.forward", "model.grouper"], "host") == 2 * 10.0 + 2 * 0.5
    assert trace.total_ms(["runner.forward", "model.grouper"], "device") == 2 * 20.0 + 2 * 1.0
    assert trace.total_ms(["no.such.span"]) is None
    with pytest.raises(ValueError, match="clock"):
        trace.total_ms(["runner.forward"], "wall")


def test_spans_past_the_bound_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a", unit=7):
            for _ in range(4):
                with trace.span("b"):
                    pass
    recs = trace.records()
    assert [(x.name, x.parent, x.unit) for x in recs] == [("a", None, 7), ("b", 0, 7), ("b", 0, 7)]
    assert trace.TRACER.dropped == 2 and trace.TRACER.stack() == []


@pytest.mark.parametrize("threads", [0, 2])
def test_the_loader_counts_its_batches_waits_and_decode_time(pcn_root, threads):  # noqa: F811
    ds = DATASETS.build(pcn_config(pcn_root, "train"))
    loader = Loader(ds, batch_size=2, shuffle=True, drop_last=True, seed=1, num_workers=threads,
                    worker_mode="thread")
    before = trace.counters()
    batches = list(loader)
    loader.close()
    d = {k: trace.counters().get(k, 0) - before.get(k, 0) for k in LOADER_COUNTERS}
    assert d["loader.batches"] == len(batches) == len(loader) == len(ds) // 2
    assert d["loader.wait_s"] > 0 and d["loader.decode_s"] > 0 and d["loader.decode_cpu_s"] > 0
    if not threads:  # decoding in the consumer's own thread: its waits hold the decode
        assert d["loader.wait_s"] >= d["loader.decode_s"]
    it = iter(loader)  # an epoch left early counts only what it took
    before = trace.counters()
    next(it)
    it.close()
    loader.close()
    assert trace.counters()["loader.batches"] - before["loader.batches"] == 1
