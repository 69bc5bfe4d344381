"""SnowFlakeNet in the port against the benchmark's plain reference
(``portbench/reference/snowflake.py``) on the CPU, where the port takes its
kernels' plain versions, at a small size: batch 2, partials of 512 points
(the extractor's first FPS takes 512 centres), ``num_pc`` 32, ``num_p0``
64, ``up_factors`` [2, 2], both sides loaded with the same seeded weights
(``portbench/weights.py``).

- The eval clouds (P1, P3), and a fault: the softmax over channels in
  place of the neighbours fails that comparison.
- Two train steps through ``Runner.train_step`` under the recipe's Adam and
  GradualWarmup against the reference's update
  (``portbench/reference/warmup.py``): both losses, every clipped gradient
  and the parameters after each update (the first update's lr is 0).
- The ``train_warmup`` kind end to end at this size: its checked steps read
  correct under the cell's limits, and it hands ``run.py`` the training
  step's FLOPs.
- The warm-up schedule against the runner's over several epochs.
- ``step_flops`` against the reference's Linear products counted by
  forward hooks.
- The reference and the kind load nothing of JAX or of the port.
- The spans: under a profiler one forward records ``model.sf_extractor``,
  ``model.sf_seed``, three ``model.sf_spd`` and five ``model.sf_attention``
  with their parents; without one it records none; the outputs are
  bit-equal either way; the neighbour-row counter.
"""

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imgadapointr_tpu_torch.tools.builder import build_opt_sched
from imgadapointr_tpu_torch.tools.runner import Runner, counters_line
from imgadapointr_tpu_torch.utils import trace
from imgadapointr_tpu_torch.utils.config import AttrDict
from portbench import compare, harness, weights, workloads
from portbench.reference import models as ref_models
from portbench.reference import nets, snowflake, warmup
from portbench.reference import optim as ref_optim

ROOT = Path(__file__).resolve().parents[1]
CELL = "snowflakenet_pcn.train_b64_mem"
B, N_PARTIAL, N_GT, SEED = 2, 512, 1024, 3
SMALL = {"num_pc": 32, "num_p0": 64, "up_factors": [2, 2]}


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    reference's FPS loops over small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.reset()
    yield
    trace.reset()


def run_config() -> dict:
    run = json.loads((ROOT / "portbench" / "configs" / "snowflakenet_pcn.json").read_text())["run"]
    run["model"].update(SMALL)
    return run


def both(seed: int = SEED):
    """(runner, reference, batch) from the same weights."""
    run = run_config()
    cfg = run["model"]
    runner = Runner(argparse.Namespace(seed=seed, device="cpu", tp=1, sp=1), AttrDict(run))
    weights.load(runner.model, weights.make("SnowFlakeNet", cfg, seed, torch.device("cpu")))
    ref = nets.load("SnowFlakeNet").build(cfg)
    weights.load(ref, weights.make("SnowFlakeNet", cfg, seed, torch.device("cpu")))
    g = torch.Generator().manual_seed(seed)
    batch = {"partial": torch.rand(B, N_PARTIAL, 3, generator=g) - 0.5, "gt": torch.rand(B, N_GT, 3, generator=g) - 0.5}
    return runner, ref, batch


def assert_eval_agrees(runner, ref, batch):
    p1, p3 = runner.predict(batch)
    ref.eval()
    with torch.no_grad():
        r1, r3 = ref(batch["partial"])
    assert p1.shape == (B, SMALL["num_p0"], 3) and p3.shape == (B, 256, 3)
    # the same float32 operations in the same order on both sides (the
    # port's plain kNN, FPS and gather select as the reference's do); a few
    # ulps of room for a BLAS that splits a product differently
    torch.testing.assert_close(p1, r1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p3, r3, rtol=1e-5, atol=1e-6)


def test_the_reference_and_the_kind_load_no_jax_nor_the_port():
    code = ("import json, sys; import portbench.reference.nets.SnowFlakeNet, portbench.reference.warmup, "
            "portbench.kinds.train_warmup; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "imgadapointr_tpu", "imgadapointr_tpu_torch", "chip_smoke"}


def test_state_dict_layout_equal():
    runner, ref, _ = both()
    port = {n: tuple(p.shape) for n, p in runner.model.state_dict().items()}
    assert port == {n: tuple(p.shape) for n, p in ref.state_dict().items()}


def test_eval_clouds_agree(one_torch_thread):
    assert_eval_agrees(*both())


def test_softmax_over_channels_fails(monkeypatch, one_torch_thread):
    monkeypatch.setattr(snowflake, "neighbour_softmax", lambda a: torch.softmax(a, dim=-1))
    with pytest.raises(AssertionError):
        assert_eval_agrees(*both())


def test_train_steps_agree(one_torch_thread):
    runner, ref, batch = both()
    run = run_config()
    steps_per_epoch = 2
    runner.make_train_state(steps_per_epoch)
    lr_of, bnm_of = warmup.schedules(run)
    ref.train()
    params = dict(ref.named_parameters())
    opt = ref_optim.AdamW(params, 0.0)
    model = runner.model
    for i in range(2):
        epoch_f = i / steps_per_epoch
        out = runner.train_step(batch, epoch_f)
        sparse, dense = ref.loss(ref(batch["partial"], bn_momentum=bnm_of(epoch_f)), batch["gt"], epoch_f)
        ref.zero_grad(set_to_none=True)
        (sparse + dense).backward()
        # float32 sums of the same terms in another order
        torch.testing.assert_close(out["sparse_loss"], sparse.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(out["dense_loss"], dense.detach(), rtol=1e-5, atol=0)
        grads = {n: p.grad for n, p in params.items()}
        ref_optim.clip(list(grads.values()), float(run.get("grad_norm_clip", 10.0)))
        # A leaf whose gradient is under 1e-3 of the median leaf's is
        # round-off alone: the biases ahead of a BatchNorm, the key and query
        # biases that cancel in q - k, the attention's output bias that the
        # softmax over the neighbours cancels. Adam moves such a leaf by its
        # round-off's sign, so the benchmark leaves it out of the change, and
        # so does this test. Every other gradient agrees to 2e-4 of its
        # leaf's largest entry: the port's plain scatter-add and chamfer
        # backward sum in another order than autograd's gather backward.
        live = compare.live_leaves({n: float(g.norm()) for n, g in grads.items()})
        assert len(live) > 0.85 * len(grads)
        for n in live:
            torch.testing.assert_close(model.get_parameter(n).grad, grads[n], rtol=0,
                                       atol=2e-4 * float(grads[n].abs().max()), msg=n)
        lr = lr_of(i, steps_per_epoch)
        assert out["lr"] == lr == 1e-3 * epoch_f / 200
        opt.step(grads, lr)
        # Adam moves each entry by about lr: a tenth of it is room for two
        # float32 ulps of the parameter, and a wrong lr or moment fails
        for n in live:
            torch.testing.assert_close(model.get_parameter(n).detach(), params[n].detach(), rtol=2.5e-7,
                                       atol=0.1 * 1e-3 * 0.5 / 200, msg=n)


def test_train_warmup_kind_reads_correct(one_torch_thread):
    cell = harness.Cell(ROOT, CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["run"]["model"].update(SMALL)
    cell.traffic = dict(cell.traffic, batch=B, pool=8, n_partial=N_PARTIAL, n_gt=N_GT)
    run = workloads.make(cell, SEED, torch.device("cpu"), harness.Spans())
    run.setup()
    out = run.window(0.1)
    assert out["units"] >= 1 and out["failed"] == 0
    run.release()
    correct, checks = compare.verdict(run.check(), cell.limits, cell.not_compared)
    assert correct, checks
    cfg = cell.config["run"]["model"]
    assert run.net.step_flops(cfg, N_PARTIAL, False) == snowflake.step_flops(cfg, N_PARTIAL, True)


def test_warmup_schedule_matches_the_runner():
    run = json.loads((ROOT / "portbench" / "configs" / "snowflakenet_pcn.json").read_text())["run"]
    per_epoch = 8
    _, lr_update, bnm = build_opt_sched(AttrDict(run), per_epoch, torch.nn.Linear(2, 2))
    lr_of, bnm_of = warmup.schedules(run)
    # the ramp, its end at epoch 200, and the after-StepLR's first two halvings
    for update in (0, 1, 7, 8, 9, 100, 1599, 1600, 1601, 2000, 2007, 2008, 2400, 2401, 2500):
        assert lr_of(update, per_epoch) == pytest.approx(lr_update(update), rel=1e-12, abs=0), update
        assert bnm_of(update / per_epoch) == bnm(update / per_epoch) == 0.1
    assert lr_of(0, per_epoch) == 0.0 and lr_of(1600, per_epoch) == 1e-3 and lr_of(2401, per_epoch) == 2.5e-4


def test_step_flops_counts_every_linear(one_torch_thread):
    """The forward's Linear FLOPs and their backward (each weight's gradient,
    each input's where it needs one), taken by hooks on the reference, equal
    ``count``'s less the vector attention's elementwise work."""
    cfg = run_config()["model"]
    _, ref, batch = both()
    fwd = bwd = 0.0

    def hook(module, inputs, output):
        nonlocal fwd, bwd
        x = inputs[0]
        f = 2.0 * x.numel() / x.shape[-1] * module.cin * module.weight.shape[0] / B
        fwd += f
        bwd += f * (1 + int(x.requires_grad))

    for m in ref.modules():
        if isinstance(m, ref_models.Linear):
            m.register_forward_hook(hook)
    ref.train()
    ref(batch["partial"])
    c = snowflake.count(cfg, N_PARTIAL)
    assert c.elementwise > 0
    assert c.fwd - c.elementwise == pytest.approx(fwd, rel=1e-12)
    assert c.bwd - 2 * c.elementwise == pytest.approx(bwd, rel=1e-12)
    assert snowflake.step_flops(cfg, N_PARTIAL, True) == c.fwd + c.bwd
    assert snowflake.step_flops(cfg, N_PARTIAL, False) == c.fwd


def test_spans_and_counter(one_torch_thread):
    runner, _, batch = both()
    model = runner.model.eval()
    x = batch["partial"]
    at_start = trace.counters()
    rows0 = at_start.get("model.sf_attention_rows", 0)
    with torch.no_grad():
        bare = model(x)
        assert trace.records() == []
        with profile(activities=[ProfilerActivity.CPU]):
            traced = model(x)
    for a, b in zip(bare, traced):
        assert torch.equal(a, b)
    recs = [r for r in trace.records() if r.name.startswith("model.sf_")]
    names = [r.name for r in recs]
    assert names.count("model.sf_extractor") == names.count("model.sf_seed") == 1
    assert names.count("model.sf_spd") == 3 and names.count("model.sf_attention") == 5
    all_recs = trace.records()
    parents = [all_recs[r.parent].name if r.parent is not None else None for r in recs]
    assert [(n, p) for n, p in zip(names, parents) if n != "model.sf_attention"] == \
        [("model.sf_extractor", None), ("model.sf_seed", None)] + [("model.sf_spd", None)] * 3
    assert [p for n, p in zip(names, parents) if n == "model.sf_attention"] == \
        ["model.sf_extractor"] * 2 + ["model.sf_spd"] * 3
    assert len({r.parent for r in recs if r.name == "model.sf_attention"}) == 4  # one a SPD
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in recs)
    # B·N·k neighbour rows: the extractor at 512 and 128 points, the SPDs at 64, 64 and 128, twice
    rows = 2 * B * 16 * (512 + 128 + 64 + 64 + 128)
    assert trace.counters()["model.sf_attention_rows"] - rows0 == rows
    assert counters_line(at_start).endswith(f"Vector attention = {rows} neighbour rows")
