"""The port's multi-GPU layer against the JAX package, on the CPU.

One 2-rank gloo group (``torch.multiprocessing``, spawned once for the
module, one thread a rank) runs every check that needs ranks and writes
its readings; the tests compare them here, in float64:

- ``sharded_nn_distance``, ``sharded_chamfer_l1`` / ``_l2`` (values and both
  gradients), ``sharded_knn`` and ``sharded_fps`` at p = 2 against the JAX
  package's ring ops on two of the conftest's 8 virtual devices: picks
  index-equal, values within 1e-12, gradients within 1e-10. kNN and FPS
  run on lattice clouds (coordinates k/64), where the JAX float32 FPS is
  exact too.
- The tiny flagship's train step (``AdaPoinTr-tiny.yaml``, batch 2, the
  JAX init carried across) at dp = 2 (one sample a rank), tp = 2 and
  sp = 2 against the JAX runner's step on one device and the port's on one
  rank: losses 1e-9 relative, every gradient 1e-8 of the norm, parameters
  after the AdamW step 1e-9 where ``|grad| > GRAD_FLOOR`` and 2 lr
  elsewhere (a sign-like first step), BN statistics 1e-10 of their scale
  (against the port's one rank: 1e-10, 1e-9 and 1e-10); both ranks end
  with bit-equal parameters and BN buffers.
- ``param_sharding_rules`` shards exactly the JAX set of flax leaves on
  the flagship and the superset.
- The loader's shards give JAX ``DataLoader(num_hosts=2/3, host_id=...)``'s
  sample ids.
- The pipeline is bit-equal to its stages run in sequence, output and
  gradients (toy stages, and the tiny encoder's tail); block 0 of the
  encoder, run outside the pipeline, within 1e-12.
- The RSS watchdog: one rank over the limit makes both exit 75 after rank
  0 wrote ``ckpt-last``.
- A 2-rank ``torchrun`` of ``main.py --device cpu --synthetic`` writes its
  checkpoints from rank 0 only and resumes at dp = 1.
"""

import os
import pathlib
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = "cfgs/PCN_models/AdaPoinTr-tiny.yaml"
B, N_IN = 2, 256
STEPS_PER_EPOCH = 4
GRAD_FLOOR = 1e-9
MODES = ("dp", "tp", "sp")  # each a 2-rank mesh: (tp, sp) = (1, 1), (2, 1), (1, 2)
WIDTHS = {"dp": (1, 1), "tp": (2, 1), "sp": (1, 2)}
PIPE_S, PIPE_M, PIPE_MB, PIPE_C = 2, 4, 2, 16


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test, restored after it (as
    ``test_torch_seg.one_torch_thread``, which this module does not import:
    the ranks import this module, and that one imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------- the ranks
def _worker(rank: int, world: int, port: int, tmp: str) -> None:
    """One rank: every check that needs the group; readings to ``tmp``."""
    import torch.distributed as tdist

    torch.set_num_threads(1)
    os.chdir(ROOT)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {"ops": _rank_ops(inputs), "steps": {m: _rank_step(inputs, m, tmp) for m in MODES},
               "pipe": _rank_pipeline(inputs), "watchdog": _rank_watchdog(inputs, tmp)}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def _rank_ops(inputs):
    from imgadapointr_tpu_torch.ops import sharded
    from imgadapointr_tpu_torch.parallel.mesh import make_mesh

    group = make_mesh(sp=2).points
    r = group.rank
    x, y = (inputs[k].chunk(2, dim=1)[r].clone().requires_grad_() for k in ("x", "y"))
    d1, d2, i1, i2 = sharded.sharded_nn_distance(x, y, group)
    out = {"d1": d1.detach(), "d2": d2.detach(), "i1": i1, "i2": i2}
    for name, fn in (("l1", sharded.sharded_chamfer_l1), ("l2", sharded.sharded_chamfer_l2)):
        loss = fn(x, y, group)
        gx, gy = torch.autograd.grad(loss, (x, y))
        out[name] = (loss.detach(), gx, gy)
    # the picks in float32, where the JAX ring runs
    x32, y32 = (inputs[k].float().chunk(2, dim=1)[r] for k in ("x", "y"))
    out["i1_f32"], out["i2_f32"] = sharded.sharded_nn_distance(x32, y32, group)[2:]
    lat, q = inputs["lattice"].float(), inputs["queries"].float()
    out["knn"] = sharded.sharded_knn(inputs["k"], lat.chunk(2, 1)[r], q.chunk(2, 1)[r], group)
    out["fps"] = sharded.sharded_fps(lat.chunk(2, 1)[r], inputs["npoint"], group)
    with pytest.raises(ValueError, match="per-rank block"):
        sharded.sharded_knn(lat.shape[1], lat.chunk(2, 1)[r], q.chunk(2, 1)[r], group)
    return out


def _rank_step(inputs, mode: str, tmp: str):
    """The tiny flagship's train step on a 2-rank mesh of ``mode``."""
    from imgadapointr_tpu_torch.ops import chamfer
    from imgadapointr_tpu_torch.parallel.mesh import shard_batch
    from imgadapointr_tpu_torch.tools.runner import Runner
    from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

    tp, sp = WIDTHS[mode]
    cfg = cfg_from_yaml_file(TINY)
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=os.path.join(tmp, mode), tp=tp, sp=sp)
    runner = Runner(args, cfg, logger="silent")
    runner.model.double()
    runner.make_train_state(STEPS_PER_EPOCH)
    with runner.tp.unsharded():
        runner.model.load_state_dict(inputs["state"], strict=True)
    batch = shard_batch(inputs["batch"], runner.mesh, strict=True)
    calls = []
    original = chamfer._points_axis_nn

    def counted(*a, **k):
        calls.append(1)
        return original(*a, **k)

    chamfer._points_axis_nn = counted
    try:
        m = runner.train_step(batch, 0.0, noise=inputs["noise"])
    finally:
        chamfer._points_axis_nn = original
    with runner.tp.unsharded(runner.optimizer):
        params = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
        grads = {n: p.grad.clone() for n, p in runner.model.named_parameters() if p.grad is not None}
        buffers = {n: b.clone() for n, b in runner.model.named_buffers()}
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": params, "grads": grads,
            "buffers": buffers, "sharded_calls": len(calls), "n_sliced": len(runner.tp.sliced),
            "batch_rows": len(batch["partial"])}


def _toy_stage(p, h, _shared):
    return torch.tanh(h @ p["W"] + p["b"])


def _rank_pipeline(inputs):
    from imgadapointr_tpu_torch.nn.blocks import PointTransformerEncoder
    from imgadapointr_tpu_torch.nn.layers import init_weights_
    from imgadapointr_tpu_torch.parallel.pipeline import (encoder_pipeline_apply, make_pipe_mesh,
                                                          pipeline_apply, stack_stage_params)

    mesh = make_pipe_mesh(pipe=PIPE_S)
    Ws, bs, x = inputs["pipe_W"], inputs["pipe_b"], inputs["pipe_x"]
    stacked = stack_stage_params({f"s{i}": {"W": Ws[i], "b": bs[i]} for i in range(PIPE_S)},
                                 [f"s{i}" for i in range(PIPE_S)])
    stacked = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    xg = x.clone().requires_grad_()
    y = pipeline_apply(_toy_stage, stacked, xg, None, mesh, microbatches=PIPE_M)
    (y * y).sum().backward()
    out = {"toy_y": y.detach(), "toy_gW": stacked["W"].grad, "toy_gb": stacked["b"].grad, "toy_gx": xg.grad}
    # the same stages in sequence, one microbatch at a time, gradients summed in order
    ref = {k: v.detach().clone().requires_grad_() for k, v in stacked.items()}
    xr = x.clone().requires_grad_()
    ys = []
    for xm in xr.chunk(PIPE_M):
        h = xm
        for s in range(PIPE_S):
            h = _toy_stage({"W": ref["W"][s], "b": ref["b"][s]}, h, None)
        (h * h).sum().backward()
        ys.append(h.detach())
    out.update(seq_y=torch.cat(ys), seq_gW=ref["W"].grad, seq_gb=ref["b"].grad, seq_gx=xr.grad)

    enc = PointTransformerEncoder(embed_dim=32, depth=5, num_heads=4, mlp_ratio=2.0, k=4, n_group=2,
                                  block_style_list=("attn-graph",) + ("attn",) * 4)
    init_weights_(enc, torch.Generator().manual_seed(5))
    enc = enc.double()
    ex, epos = inputs["enc_x"], inputs["enc_pos"]
    yp = encoder_pipeline_apply(enc, ex, epos, mesh, microbatches=PIPE_M)
    (yp * yp).sum().backward()
    pipe_grads = {n: p.grad.clone() for n, p in enc.named_parameters() if p.grad is not None}
    enc.zero_grad(set_to_none=True)
    from imgadapointr_tpu_torch.ops import knn_point

    blocks = list(enc.blocks.blocks)
    h0 = blocks[0](ex, epos, idx=knn_point(enc.k, epos, epos))
    h0d = h0.detach().requires_grad_()
    ys, g0 = [], []
    for hm in h0d.chunk(PIPE_M):
        h = hm
        for blk in blocks[1:]:
            h = blk(h, None)
        (h * h).sum().backward()
        ys.append(h.detach())
    h0.backward(h0d.grad)
    seq_grads = {n: p.grad.clone() for n, p in enc.named_parameters() if p.grad is not None}
    out.update(enc_y=yp.detach(), enc_seq_y=torch.cat(ys), enc_grads=pipe_grads, enc_seq_grads=seq_grads,
               stage=mesh.coords[1])
    return out


def _rank_watchdog(inputs, tmp: str):
    """Rank 1 reads an RSS over the limit, rank 0 one under it: both save
    (rank 0 writes) and exit 75."""
    from imgadapointr_tpu_torch.tools import runner as runner_mod
    from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(TINY)
    path = os.path.join(tmp, "watchdog")
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=path, tp=1, sp=1)
    runner = runner_mod.Runner(args, cfg, logger="silent")
    runner.make_train_state(STEPS_PER_EPOCH)
    rank = runner.mesh.rank
    kb = 50_000_000 if rank == 1 else 500_000
    os.environ["IMGADAPOINTR_RSS_LIMIT_GB"] = "10"
    original = runner_mod._proc_status
    runner_mod._proc_status = lambda: f"VmHWM:\t90000000 kB\nVmRSS:\t{kb} kB\n"
    try:
        runner_mod.rss_watchdog(runner, 0, 3, False, None, "silent")
        code = None
    except SystemExit as stop:
        code = stop.code
    finally:
        runner_mod._proc_status = original
        del os.environ["IMGADAPOINTR_RSS_LIMIT_GB"]
    return {"code": code, "files": sorted(os.listdir(path)) if os.path.isdir(path) else []}


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step of the tiny flagship in float64 (batch 2, fixed
    denoise noise) with its gradients, and the port's inputs for it."""
    import jax
    import jax.numpy as jnp

    import imgadapointr_tpu.ops as jops
    from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
    from imgadapointr_tpu.tools.runner import Runner as JaxRunner
    from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
    from parity.param_source import init_variables
    from test_torch_train import _np_tree, x64

    cfg = jax_cfg(TINY)
    rng = np.random.RandomState(31)
    batch = {"partial": rng.randn(B, N_IN, 3) * 0.3, "gt": rng.randn(B, int(cfg.model.num_points), 3) * 0.3}
    noise = rng.randn(B, 64, 3)
    patch = pytest.MonkeyPatch()
    with x64():
        variables = jax.jit(lambda: init_variables(cfg.model, "adapointr", batch=B, n_points=N_IN)[1])()
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), dict(variables))
        runner = JaxRunner(types.SimpleNamespace(tp=1), cfg)
        runner.tx, runner.lr_sched, runner.bnm_sched = jax_build_opt_sched(cfg, STEPS_PER_EPOCH,
                                                                           variables["params"])
        runner.steps_per_epoch = STEPS_PER_EPOCH
        state = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                 "opt_state": runner.tx.init(variables["params"]), "step": jnp.zeros((), jnp.int32)}
        key = jax.random.PRNGKey(0)
        patch.setattr(jops, "jitter_points",
                      lambda key, pc, std=0.01, clip=0.05: pc + jnp.clip(std * jnp.asarray(noise), -clip, clip))

        def step_and_grads(state, batch):
            def loss(params):
                ret, _ = runner.module.apply(
                    {"params": params, "batch_stats": state["batch_stats"]}, batch["partial"], train=True,
                    bn_momentum=runner.bnm_sched(0.0), rngs={"noise": key, "dropout": key},
                    mutable=["batch_stats"])
                sparse, dense = runner.spec.loss_fn(ret, batch["gt"], 0.0)
                return sparse + dense

            return runner._train_step(state, batch, key, 0.0), jax.grad(loss)(state["params"])

        try:
            (new, metrics), grads = jax.jit(step_and_grads)(state, {k: jnp.asarray(v) for k, v in batch.items()})
        finally:
            patch.undo()
        return {"state0": _np_tree(state), "state1": _np_tree(new), "grads": _np_tree(grads),
                "metrics": {k: float(v) for k, v in metrics.items()}, "batch": batch, "noise": noise}


def _port_state(jax_step):
    """The JAX init as the port's float64 state dict (``test_torch_train``'s loader)."""
    from test_torch_train import _port_runner

    runner, _ = _port_runner({}, jax_step["state0"], pathlib.Path("."))
    return {k: v.clone() for k, v in runner.model.state_dict().items()}


@pytest.fixture(scope="module")
def ranks(jax_step, tmp_path_factory):
    """Both ranks' readings, from one spawned 2-rank gloo group."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    rng = np.random.RandomState(7)
    lattice = rng.randint(-64, 65, (2, 64, 3)) / 64.0
    inputs = {
        "x": torch.from_numpy(rng.randn(2, 64, 3)), "y": torch.from_numpy(rng.randn(2, 48, 3)),
        "lattice": torch.from_numpy(lattice), "queries": torch.from_numpy(lattice[:, ::2].copy()),
        "k": 8, "npoint": 16,
        "state": _port_state(jax_step),
        "batch": {k: torch.from_numpy(v) for k, v in jax_step["batch"].items()},
        "noise": torch.from_numpy(jax_step["noise"]),
        "pipe_W": torch.from_numpy(rng.randn(PIPE_S, PIPE_C, PIPE_C) * 0.3),
        "pipe_b": torch.from_numpy(rng.randn(PIPE_S, PIPE_C) * 0.1),
        "pipe_x": torch.from_numpy(rng.randn(PIPE_M * PIPE_MB, 8, PIPE_C)),
        "enc_x": torch.from_numpy(rng.randn(PIPE_M * PIPE_MB, 16, 32)),
        "enc_pos": torch.from_numpy(rng.randn(PIPE_M * PIPE_MB, 16, 3)),
    }
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    torch.multiprocessing.start_processes(_worker, args=(2, _free_port(), tmp), nprocs=2, join=True,
                                          start_method="spawn")
    return inputs, [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)], tmp


# ------------------------------------------------------------------- tests
def test_sharded_ops_match_jax(ranks):
    """Float64: the port's sharded ops against the JAX package's unsharded
    ops (its ring ops' own contract; the ring carries float32 and does not
    run under x64): values 1e-12, gradients 1e-10, picks equal. Float32:
    the picks against the JAX ring on two devices, index-equal."""
    import jax
    import jax.numpy as jnp

    import imgadapointr_tpu.ops as jops
    from imgadapointr_tpu.ops import sharded as jsharded
    from test_torch_train import x64

    inputs, got, _ = ranks
    ops = [g["ops"] for g in got]

    def cat(k):
        return torch.cat([o[k] for o in ops], dim=1).numpy()

    with x64():
        x, y = jnp.asarray(inputs["x"].numpy()), jnp.asarray(inputs["y"].numpy())
        d1, d2, i1, i2 = jops.nn_distance(x, y)
        for k, w in (("d1", d1), ("d2", d2)):
            np.testing.assert_allclose(cat(k), np.asarray(w), rtol=0, atol=1e-12, err_msg=k)
        for k, w in (("i1", i1), ("i2", i2)):
            np.testing.assert_array_equal(cat(k), np.asarray(w), err_msg=k)
        for name, fn in (("l1", jops.chamfer_l1), ("l2", jops.chamfer_l2)):
            val, (gx, gy) = jax.value_and_grad(lambda a, b: fn(a, b), argnums=(0, 1))(x, y)
            for o in ops:  # the loss is replicated
                np.testing.assert_allclose(float(o[name][0]), float(val), rtol=1e-12, err_msg=name)
            for j, g in ((1, gx), (2, gy)):
                mine = torch.cat([o[name][j] for o in ops], dim=1).numpy()
                np.testing.assert_allclose(mine, np.asarray(g), rtol=0, atol=1e-10, err_msg=name)
    mesh = jsharded.make_points_mesh(jax.devices()[:2])
    x32, y32 = (jnp.asarray(inputs[k].numpy(), jnp.float32) for k in ("x", "y"))
    _, _, j1, j2 = jsharded.sharded_nn_distance(x32, y32, mesh)
    np.testing.assert_array_equal(cat("i1_f32"), np.asarray(j1))
    np.testing.assert_array_equal(cat("i2_f32"), np.asarray(j2))
    lat = jnp.asarray(inputs["lattice"].numpy(), jnp.float32)
    q = jnp.asarray(inputs["queries"].numpy(), jnp.float32)
    np.testing.assert_array_equal(cat("knn"), np.asarray(jsharded.sharded_knn(inputs["k"], lat, q, mesh)))
    fps = np.asarray(jsharded.sharded_fps(lat, inputs["npoint"], mesh))
    for o in ops:
        np.testing.assert_array_equal(o["fps"].numpy(), fps)
    assert len(np.unique(np.asarray(i1))) > 10  # real picks, not one point


def _check_against(name, got, want_metrics, want_grads, want_params, want_bn, lr, tol):
    """A step's readings against a reference step's (tolerances: loss,
    gradient over the norm, live parameters, BN statistics)."""
    loss_rtol, grad_tol, param_tol, bn_tol = tol
    for k in ("sparse_loss", "dense_loss", "total_loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], want_metrics[k], rtol=loss_rtol, err_msg=f"{name} {k}")
    norm = want_metrics["grad_norm"]
    coef = min(10.0 / (norm + 1e-6), 1.0)
    n_checked = 0
    for n, g in got["grads"].items():
        jg = want_grads[n] * coef if want_grads is not None else None
        if jg is None:
            continue
        assert float(np.abs(g.numpy() - jg).max()) <= grad_tol * norm, f"{name} {n}"
        live = np.abs(jg) > GRAD_FLOOR
        diff = np.abs(got["params"][n].numpy() - want_params[n])
        assert float(diff[live].max(initial=0.0)) <= param_tol, f"{name} {n}"
        assert float(diff.max()) <= 2.0 * lr + 1e-9, f"{name} {n}"
        n_checked += 1
    assert n_checked > 50, name
    for k, w in want_bn.items():
        np.testing.assert_allclose(got["buffers"][k].numpy(), w, rtol=0, atol=bn_tol * float(np.abs(w).max()),
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax_and_one_rank(ranks, jax_step, mode, tmp_path, one_torch_thread):
    from imgadapointr_tpu_torch.tools.convert import _params_from_flax
    from imgadapointr_tpu_torch.tools.runner import Runner
    from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

    inputs, got, _ = ranks
    steps = [g["steps"][mode] for g in got]
    cfg = cfg_from_yaml_file(TINY)
    # both ranks end in the same state, bit for bit
    for key in ("params", "buffers"):
        for n, v in steps[0][key].items():
            assert torch.equal(v, steps[1][key][n]), f"{mode} {key} {n}"
    assert steps[0]["metrics"] == steps[1]["metrics"]
    if mode == "dp":
        assert [s["batch_rows"] for s in steps] == [1, 1]
    if mode == "tp":
        assert steps[0]["n_sliced"] > 10
    if mode == "sp":
        assert steps[0]["sharded_calls"] >= 2  # the losses ran on the point axis

    # against JAX on one device
    bn = jax_step["state1"]["batch_stats"]["increase_dim_bn"]
    want_bn = {"base_model.increase_dim.1.running_mean": bn["mean"], "base_model.increase_dim.1.running_var": bn["var"]}
    want_bn = {k if k in steps[0]["buffers"] else k.replace("base_model.", ""): v for k, v in want_bn.items()}
    jgrads = _params_from_flax(jax_step["grads"], cfg.model)
    jparams = _params_from_flax(jax_step["state1"]["params"], cfg.model)
    lr = jax_step["metrics"]["lr"]
    _check_against(f"{mode} vs JAX", steps[0], jax_step["metrics"], jgrads, jparams, want_bn, lr,
                   (1e-9, 1e-8, 1e-9, 1e-10))

    # against the port's step on one rank
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path))
    runner = Runner(args, cfg, logger="silent")
    runner.model.double()
    runner.make_train_state(STEPS_PER_EPOCH)
    runner.model.load_state_dict(inputs["state"], strict=True)
    m = runner.train_step(inputs["batch"], 0.0, noise=inputs["noise"])
    one = {"metrics": {k: float(v) for k, v in m.items()}}
    one_grads = {n: p.grad.numpy() for n, p in runner.model.named_parameters() if p.grad is not None}
    # the one-rank gradients are clipped already: undo the coefficient for _check_against
    coef = min(10.0 / (one["metrics"]["grad_norm"] + 1e-6), 1.0)
    one_grads = {n: g / coef for n, g in one_grads.items()}
    one_params = {n: p.detach().numpy() for n, p in runner.model.named_parameters()}
    one_bn = {k: runner.model.state_dict()[k].numpy() for k in want_bn}
    assert set(one_grads) == set(steps[0]["grads"])  # the zero-grad subtrees stay None on every mesh
    _check_against(f"{mode} vs one rank", steps[0], one["metrics"], one_grads, one_params, one_bn, lr,
                   (1e-10, 1e-9, 1e-9, 1e-10))


def test_param_sharding_rules_shard_the_jax_set():
    """The flax leaves the port shards at tp = 2 are the JAX rule's, on the
    flagship and on the superset (shapes from ``jax.eval_shape``)."""
    import jax
    import jax.numpy as jnp

    from imgadapointr_tpu.models.build import build_model_spec
    from imgadapointr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from imgadapointr_tpu.parallel.mesh import param_sharding_rules as jax_rules
    from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
    from imgadapointr_tpu_torch.models import adapointr, seg_adapointr
    from imgadapointr_tpu_torch.parallel.mesh import sharded_flax_leaves
    from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
    from imgadapointr_tpu_torch.utils.registry import MODELS

    mesh = jax_make_mesh(jax.devices()[:2], tp=2)
    for path, kind in (("cfgs/PCN_models/AdaPoinTr.yaml", "pc"),
                       ("cfgs/SegImgPCN_models/ImgEncSegDecAdaPoinTrVariableLoss.yaml", "imgsegdec")):
        spec = build_model_spec(jax_cfg(path).model)
        inputs = [jax.ShapeDtypeStruct((1, 2048, 3), jnp.float32)]
        if kind == "imgsegdec":
            inputs += [jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32),
                       jax.ShapeDtypeStruct((1, 16), jnp.float32)]
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda *a: spec.module.init({"params": key, "noise": key, "dropout": key},
                                                            *a, train=False), *inputs)["params"]
        rules = jax_rules(shapes, mesh)
        want = set()
        for kp, s in jax.tree_util.tree_flatten_with_path(rules)[0]:
            if s.spec != jax.sharding.PartitionSpec():
                want.add(tuple(k.key for k in kp))
        cfg = cfg_from_yaml_file(path).model
        with pytest.MonkeyPatch.context() as mp, torch.device("meta"):
            for module in (adapointr, seg_adapointr):  # no init, no device: shapes only
                mp.setattr(module, "place", lambda model, *a, **k: model)
            model = MODELS.build(cfg)
        got = sharded_flax_leaves(model, cfg, 2)
        assert got == want, (path, sorted(got ^ want)[:10])
        assert len(want) > 50


def test_loader_shards_match_jax_hosts():
    from imgadapointr_tpu.datasets.loader import DataLoader as JaxLoader
    from imgadapointr_tpu_torch.datasets.loader import EpochOrderSampler

    class Ids:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

    for n, hosts in ((9, 2), (10, 3), (16, 2)):
        for host in range(hosts):
            for shuffle in (True, False):
                jl = JaxLoader(Ids(n), batch_size=2, shuffle=shuffle, drop_last=True, seed=5,
                               num_hosts=hosts, host_id=host)
                sampler = EpochOrderSampler(n, shuffle, seed=5, num_hosts=hosts, host_id=host)
                for epoch in (0, 1):
                    jl.set_epoch(epoch)
                    sampler.set_epoch(epoch)
                    np.testing.assert_array_equal(sampler.order(), jl._epoch_indices())
                    assert len(sampler) == len(jl._epoch_indices())


def test_pipeline_is_bit_equal_to_its_stages_in_sequence(ranks):
    _, got, _ = ranks
    for g in got:
        p = g["pipe"]
        for k in ("y", "gW", "gb", "gx"):
            assert torch.equal(p[f"toy_{k}"], p[f"seq_{k}"]), k
        assert torch.equal(p["enc_y"], p["enc_seq_y"])
        # each rank holds the gradients of its own stage's blocks, and of
        # block 0, which every rank runs; all bit-equal to the sequence's
        own = np.array_split(np.arange(1, 5), PIPE_S)[p["stage"]].tolist()
        mine = [n for n in p["enc_seq_grads"] if n.startswith("blocks.blocks.") and int(n.split(".")[2]) in own]
        assert mine and set(mine) == {n for n in p["enc_grads"] if not n.startswith("blocks.blocks.0.")}
        for n in mine:
            assert torch.equal(p["enc_grads"][n], p["enc_seq_grads"][n]), n
        for n, v in p["enc_grads"].items():
            if n.startswith("blocks.blocks.0."):
                torch.testing.assert_close(v, p["enc_seq_grads"][n], rtol=0, atol=1e-12)
    stages = sorted(g["pipe"]["stage"] for g in got)
    assert stages == [0, 1]
    owned = [{n for n, v in g["pipe"]["enc_grads"].items() if not n.startswith("blocks.blocks.0.")} for g in got]
    assert not owned[0] & owned[1] and len(owned[0] | owned[1]) == len(got[0]["pipe"]["enc_seq_grads"]) - len(
        [n for n in got[0]["pipe"]["enc_seq_grads"] if n.startswith("blocks.blocks.0.")])


def test_rss_watchdog_stops_every_rank_together(ranks):
    _, got, _ = ranks
    assert [g["watchdog"]["code"] for g in got] == [75, 75]
    assert "ckpt-last.pth" in got[0]["watchdog"]["files"]


def test_torchrun_main_writes_from_rank_zero_and_resumes_at_dp1(tmp_path):
    """A 2-rank ``torchrun`` of ``main`` on the CPU (gloo): one epoch of the
    tiny config on small synthetic clouds; every checkpoint written once,
    by rank 0; then one process resumes it for a second epoch."""
    import shutil

    shutil.copytree(ROOT / "cfgs", tmp_path / "cfgs")
    wrapper = tmp_path / "launch.py"
    wrapper.write_text(f"""
import os, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from imgadapointr_tpu_torch import main as m
from imgadapointr_tpu_torch.utils import checkpoint as ck
from imgadapointr_tpu_torch.tools import runner as r
swap = m.swap_synthetic
def small(config, train_len=None):
    swap(config, train_len)
    config.total_bs = 2
    for name, split in config.dataset.items():
        split["N_PARTIAL"] = 256
        if name != "train":
            split["LENGTH"] = 2
m.swap_synthetic = small
save = ck.save_checkpoint
def record(*a, **k):
    with open(f"saves-{{os.environ.get('RANK', 'solo')}}.txt", "a") as f:
        f.write(a[6] + "\\n")
    return save(*a, **k)
r.save_checkpoint = record
m.main(sys.argv[1:])
""")
    base = ["--config", TINY, "--exp_name", "mp", "--device", "cpu", "--synthetic", "--syn_train_len", "4",
            "--num_workers", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cfg_path = tmp_path / "cfgs" / "PCN_models" / "AdaPoinTr-tiny.yaml"
    assert "\nmax_epoch: 2\n" in cfg_path.read_text()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                           "--master_port", str(_free_port()), str(wrapper), *base, "--launcher", "pytorch"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert (tmp_path / "saves-0.txt").exists() and not (tmp_path / "saves-1.txt").exists()
    saved = (tmp_path / "saves-0.txt").read_text().split()
    assert "ckpt-last" in saved and "ckpt-best" in saved
    exp = tmp_path / "experiments" / "AdaPoinTr-tiny" / "PCN_models" / "mp"
    assert (exp / "ckpt-last.pth").exists()
    logs = list(exp.glob("*.log"))
    assert len(logs) == 1  # rank 0's
    meta = torch.load(exp / "ckpt-last.pth", weights_only=False)
    assert meta["epoch"] == 1 and meta["step"] == 4  # 2 epochs of 2 batches of 1 a rank
    # resume at dp = 1: one more epoch from the 2-rank run's ckpt-last
    saved_cfg = exp / "config.yaml"  # --resume reads the experiment's copy
    saved_cfg.write_text(saved_cfg.read_text().replace("\nmax_epoch: 2\n", "\nmax_epoch: 3\n"))
    proc = subprocess.run([sys.executable, str(wrapper), *base, "--resume"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    meta = torch.load(exp / "ckpt-last.pth", weights_only=False)
    assert meta["epoch"] == 2 and meta["step"] == 6  # one more epoch: 2 batches of 2
