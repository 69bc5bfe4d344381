"""The five PCN baselines of the port against the JAX package, on the CPU.

FoldingNet, PCN, TopNet, SnowFlakeNet and GRNet at small widths (the
shipped configs with the model keys of ``SMALL``), weights drawn with numpy
on the shapes ``jax.eval_shape`` gives (``random_tree``, float32), carried
across by ``state_dict_from_flax`` and run in float64 on both sides:

- the eval forward against ``module.apply(..., train=False)``, 1e-9
  absolute on clouds of unit scale;
- one train step through ``Runner.train_step`` with the config's Adam
  against ``Runner._train_step`` of the JAX package: the losses and the
  lr 1e-9 relative, every gradient (after the clip) 1e-9 of the global
  gradient norm, every BN running statistic 1e-10, and every parameter
  after the update within 1e-9 plus what the gradient's difference moves
  the first Adam update ``lr g / (|g| + eps)`` by (twice ``lr eps |dg| /
  (|g| + eps)²``: a gradient of rounding noise may step the other way).

GRNet's point sampling takes JAX's own uniform scores: ``PRNGKey(0)``'s in
eval mode, and in the train step the key the JAX module draws from the
step's 'noise' stream (``make_rng`` on the same scope), handed to the port
as ``noise``. SnowFlakeNet's shipped schedule (GradualWarmup from 0) gives
the first update lr 0, so its step runs under the configs' StepLR.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
from imgadapointr_tpu.tools.runner import Runner as JaxRunner
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch.models import BASELINES
from imgadapointr_tpu_torch.models import grnet as port_grnet
from imgadapointr_tpu_torch.models.baselines import Baseline
from imgadapointr_tpu_torch.nn.layers import BatchNorm
from imgadapointr_tpu_torch.tools.convert import _leaf, _params_from_flax, state_dict_from_flax
from imgadapointr_tpu_torch.tools.runner import Runner
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from imgadapointr_tpu_torch.utils.device import deterministic_cudnn, resolve_device
from imgadapointr_tpu_torch.utils.registry import MODELS
from test_torch_seg import as_f64, one_torch_thread, random_tree, x64  # noqa: F401  (one fixture)

# model keys over the shipped config, (batch, input points, gt points)
SMALL = {
    "FoldingNet": ({"num_pred": 256, "encoder_channel": 64}, (2, 128, 300)),
    "PCN": ({"num_pred": 256, "encoder_channel": 64}, (2, 128, 300)),
    "TopNet": ({"num_pred": 2048, "encoder_channel": 64, "nlevels": 4, "node_feature": 4}, (4, 128, 300)),
    "SnowFlakeNet": ({"dim_feat": 64, "num_pc": 32, "num_p0": 64, "up_factors": [2, 2]}, (2, 600, 300)),
    "GRNet": ({"num_pred": 256}, (1, 128, 300)),
}
STEPS_PER_EPOCH = 4
ADAM_EPS = 1e-8
STEP_LR = {"type": "StepLR", "kwargs": {"step_size": 50, "gamma": 0.5}}


def configs(name: str):
    """(JAX config, port config) of the shipped ``name`` at its small widths."""
    path = f"cfgs/PCN_models/{name}.yaml"
    out = []
    for load in (jax_cfg, cfg_from_yaml_file):
        cfg = load(path)
        for k, v in SMALL[name][0].items():
            cfg.model[k] = v
        if name == "SnowFlakeNet":
            cfg.scheduler = STEP_LR
        out.append(cfg)
    return out


def grnet_scores(module, variables, key, B: int, n: int):
    """The uniform scores GRNet's point sampling draws from 'noise' stream ``key``."""
    sub = module.apply(variables, rngs={"noise": key}, method=lambda m: m.make_rng("noise"))
    return np.array(jax.random.uniform(sub, (B, n)))


@pytest.fixture(scope="module", params=list(SMALL))
def jax_run(request):
    """The JAX package's eval forward and one train step (with the step's
    gradients) of a baseline, from numpy-seeded weights."""
    name = request.param
    jcfg, pcfg = configs(name)
    B, n_in, n_gt = SMALL[name][1]
    rng = np.random.RandomState(17)
    batch = {"partial": rng.uniform(-0.45, 0.45, (B, n_in, 3)), "gt": rng.uniform(-0.45, 0.45, (B, n_gt, 3))}
    out = {"name": name, "jcfg": jcfg, "pcfg": pcfg, "batch": batch}
    runner = JaxRunner(types.SimpleNamespace(tp=1), jcfg)
    module = runner.module
    key = jax.random.PRNGKey(3)
    with x64():
        x = jnp.asarray(batch["partial"])
        shapes = jax.eval_shape(lambda: module.init({"params": key, "noise": key}, x, train=True))
        v = random_tree(dict(shapes), 29)
        out["variables"] = v
        variables = as_f64(v)
        n_cloud = n_in + port_grnet.GRID**3
        if name == "GRNet":
            out["eval_scores"] = np.array(jax.random.uniform(jax.random.PRNGKey(0), (B, n_cloud)))
            out["train_scores"] = grnet_scores(module, variables, jax.random.split(key, 3)[0], B, n_cloud)
        out["eval"] = [np.asarray(o) for o in jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)]
        runner.tx, runner.lr_sched, runner.bnm_sched = jax_build_opt_sched(
            jcfg, STEPS_PER_EPOCH, variables["params"])
        state = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                 "opt_state": runner.tx.init(variables["params"]), "step": jnp.zeros((), jnp.int32)}

        def step_and_grads(state, batch):
            def loss(params):
                ret, _ = module.apply(
                    {"params": params, "batch_stats": state["batch_stats"]}, batch["partial"], train=True,
                    bn_momentum=runner.bnm_sched(0.0), rngs={"noise": jax.random.split(key, 3)[0]},
                    mutable=["batch_stats"])
                sparse, dense = runner.spec.loss_fn(ret, batch["gt"], 0.0)
                return sparse + dense

            return runner._train_step(state, batch, key, 0.0), jax.grad(loss)(state["params"])

        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        (new_state, metrics), grads = jax.jit(step_and_grads)(state, jb)
        out["metrics"] = {k: float(a) for k, a in metrics.items()}
        out["grads"] = jax.tree_util.tree_map(np.asarray, grads)
        out["new_params"] = jax.tree_util.tree_map(np.asarray, new_state["params"])
        out["new_stats"] = jax.tree_util.tree_map(np.asarray, new_state["batch_stats"])
    return out


def port_runner(jax_run, tmp_path):
    """The port's runner in float64 on the CPU with the JAX run's weights."""
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path))
    runner = Runner(args, jax_run["pcfg"], logger="silent")
    v = jax_run["variables"]
    sd = state_dict_from_flax(v["params"], v["batch_stats"], jax_run["pcfg"].model)
    runner.model.double()
    runner.model.load_state_dict(sd, strict=True)
    runner.make_train_state(STEPS_PER_EPOCH)
    return runner


def test_eval_forward_matches_jax(jax_run, tmp_path, one_torch_thread):
    runner = port_runner(jax_run, tmp_path)
    x = torch.from_numpy(jax_run["batch"]["partial"])
    noise = jax_run.get("eval_scores")
    with torch.no_grad():
        got = runner.model.eval()(x, noise=None if noise is None else torch.from_numpy(noise))
    assert len(got) == len(jax_run["eval"]) == 2
    for g, w in zip(got, jax_run["eval"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9)
    assert float(np.abs(jax_run["eval"][1]).max()) > 0.05  # not a collapsed cloud


def test_adam_train_step_matches_jax(jax_run, tmp_path, one_torch_thread):
    runner = port_runner(jax_run, tmp_path)
    assert isinstance(runner.optimizer, torch.optim.Adam)
    batch = {k: torch.from_numpy(a) for k, a in jax_run["batch"].items()}
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    noise = jax_run.get("train_scores")
    got = runner.train_step(batch, 0.0, noise=None if noise is None else torch.from_numpy(noise))
    want = jax_run["metrics"]
    for k in ("sparse_loss", "dense_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)
    assert want["lr"] > 0 and runner.step == 1

    cfg = jax_run["pcfg"].model
    norm = want["grad_norm"]
    coef = min(10.0 / (norm + 1e-6), 1.0)
    jgrads = _params_from_flax(jax_run["grads"], cfg)
    jparams = _params_from_flax(jax_run["new_params"], cfg)
    assert set(jgrads) == {n for n, _ in runner.model.named_parameters()}
    lr = want["lr"]
    for name, p in runner.model.named_parameters():
        g, jg = p.grad.numpy(), jgrads[name] * coef
        g_err = np.abs(g - jg)
        assert float(g_err.max()) <= 1e-9 * norm, name
        # the first Adam update is lr g / (|g| + eps): its error from the gradient's
        tol = 1e-9 + 2.0 * lr * ADAM_EPS * g_err / (np.abs(jg) + ADAM_EPS) ** 2
        diff = np.abs(p.detach().numpy() - jparams[name])
        assert bool((diff <= tol).all()), (name, float((diff - tol).max()))
        assert not torch.equal(p, before[name]) or not jg.any(), name

    for mname, mod in runner.model.named_modules():
        if isinstance(mod, BatchNorm):
            path = tuple(mname.split("."))
            for got_s, leaf in ((mod.running_mean, "mean"), (mod.running_var, "var")):
                want_s = _leaf(jax_run["new_stats"], path + (leaf,))
                np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                                           atol=1e-10 * max(float(np.abs(want_s).max()), 1.0), err_msg=mname)


# ------------------------------------------------------------ schedules


SCHEDULES = {
    "StepLR": {"type": "StepLR", "kwargs": {"step_size": 50, "gamma": 0.5}},  # the PCN baselines'
    "GradualWarmup-kwargs_1_2": None,  # SnowFlakeNet.yaml's own block
    "CosLR": {"type": "CosLR", "kwargs": {"t_max": 300, "min_lr": 1e-6, "initial_epochs": 10}},
    "GradualWarmup-after": {"type": "GradualWarmup", "kwargs": {
        "multiplier": 2.0, "total_epoch": 10, "after": {"type": "StepLR", "kwargs": {"decay_step": 30,
                                                                                      "gamma": 0.3}}}},
    "GradualWarmup-hold": {"type": "GradualWarmup", "kwargs": {"multiplier": 2.0, "total_epoch": 10}},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedules_match_jax(name):
    """Each schedule against the JAX function on a grid of float epochs
    (0-400, steps of 1/4 and the hand-over points), 1e-14 relative. The
    JAX GradualWarmup without an after-schedule holds ``base_lr *
    multiplier`` as a float32 constant; the port holds it in float64, so
    there the two agree to float32 rounding."""
    from imgadapointr_tpu.utils import schedulers as jsched
    from imgadapointr_tpu.utils.config import AttrDict as JaxAttrDict
    from imgadapointr_tpu_torch.utils import schedulers
    from imgadapointr_tpu_torch.utils.config import AttrDict

    block = SCHEDULES[name]
    if block is None:
        jblock, pblock = (load("cfgs/PCN_models/SnowFlakeNet.yaml").scheduler
                          for load in (jax_cfg, cfg_from_yaml_file))
    else:
        jblock, pblock = JaxAttrDict(block), AttrDict(block)
    base_lr = 1e-3
    epochs = np.unique(np.concatenate([np.arange(0.0, 400.0, 0.25), [9.999, 10.0, 10.001, 199.99, 200.0,
                                                                      200.01, 250.0, 249.99]]))
    with x64():
        j_lr = jsched.build_lr_schedule(base_lr, jblock, 300)
        want = np.array([float(j_lr(jnp.asarray(e))) for e in epochs])
    lr = schedulers.build_lr_schedule(base_lr, pblock, 300)
    got = np.array([lr(e) for e in epochs])
    assert all(isinstance(lr(e), float) for e in epochs[:3])
    if name == "GradualWarmup-hold":
        warm = epochs <= 10
        np.testing.assert_allclose(got[warm], want[warm], rtol=1e-14)
        assert (got[~warm] == base_lr * 2.0).all()
        np.testing.assert_allclose(got[~warm], want[~warm], rtol=2.0**-24)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-300)
    assert len(set(got.tolist())) > 3  # the schedule moves over the grid


# ------------------------------------------------------------ optimizers


class _Params(torch.nn.Module):
    """Named float64 parameters: a matrix and a vector that train, and a
    ``query_ranking`` matrix whose gradient stays None."""

    def __init__(self, rng):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(rng.randn(5, 4)))
        self.b = torch.nn.Parameter(torch.from_numpy(rng.randn(4)))
        self.query_ranking = torch.nn.Parameter(torch.from_numpy(rng.randn(3, 3)))


OPTIMIZERS = {
    "Adam": {"type": "Adam", "kwargs": {"lr": 1e-3, "weight_decay": 1e-2}},
    "SGD": {"type": "SGD", "kwargs": {"lr": 0.1, "weight_decay": 1e-3}},
    "SGD-momentum": {"type": "SGD", "kwargs": {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-3}},
    "SGD-nesterov": {"type": "SGD", "kwargs": {"lr": 0.1, "momentum": 0.9, "nesterov": True,
                                               "weight_decay": 1e-3}},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    """Four updates of the port's optimizer (the runner's clip at 10, then
    ``step`` at the scheduled lr) against the JAX package's optax chain on
    the same named parameters and gradients (StepLR halving every 2
    epochs at 1 update an epoch; the second gradient's norm 40 engages the
    clip): parameters 1e-12 relative. The ``query_ranking`` parameter has
    no gradient in the port and a zero one in optax: neither moves it."""
    cfg_j, cfg_p = jax_cfg("cfgs/PCN_models/FoldingNet.yaml"), cfg_from_yaml_file("cfgs/PCN_models/FoldingNet.yaml")
    for cfg in (cfg_j, cfg_p):
        cfg.optimizer = OPTIMIZERS[name]
        cfg.scheduler = {"type": "StepLR", "kwargs": {"step_size": 2, "gamma": 0.5}}
    rng = np.random.RandomState(8)
    model = _Params(rng)
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    grads = [{n: rng.randn(*a.shape) * s for n, a in start.items() if n != "query_ranking"} for s in (1, 20, 0.5, 2)]
    from imgadapointr_tpu_torch.tools import builder

    opt, lr_update, _ = builder.build_opt_sched(cfg_p, 1, model)
    for u, g in enumerate(grads):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy()) if n in g else None
        torch.nn.utils.clip_grad_norm_([p for p in model.parameters()], 10.0)
        for group in opt.param_groups:
            group["lr"] = lr_update(u)
        opt.step()
    with x64():
        params = {n: jnp.asarray(a) for n, a in start.items()}
        tx, _, _ = jax_build_opt_sched(cfg_j, 1, params)
        state = tx.init(params)
        for g in grads:
            jgrad = {n: jnp.asarray(g.get(n, np.zeros_like(a))) for n, a in start.items()}
            updates, state = tx.update(jgrad, state, params)
            params = jax.tree_util.tree_map(lambda p, d: p + d, params, updates)
    assert lr_update(3) == 0.5 * lr_update(0)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=1e-12, atol=1e-15, err_msg=n)
    np.testing.assert_array_equal(model.query_ranking.detach().numpy(), start["query_ranking"])
    assert not np.allclose(model.w.detach().numpy(), start["w"])


def test_k2_accumulation_matches_optax_multisteps(tmp_path, one_torch_thread):
    """``AdaPoinTr-tiny-k2.yaml`` (``step_per_update: 2``, AdamW, clip 10)
    in float64: two ``Runner.train_step`` calls sum the two batches'
    gradients and take one update; the first leaves every parameter and the
    optimizer untouched and logs no ``grad_norm``. Against the JAX
    package's optimizer (``optax.MultiSteps`` over a scale by k, the clip
    and AdamW) fed the same two per-batch gradients, taken from the same
    starting state: parameters 1e-12, the logged norm 1e-12 relative."""
    cfg = cfg_from_yaml_file("cfgs/PCN_models/AdaPoinTr-tiny-k2.yaml")
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path))
    runner = Runner(args, cfg, logger="silent")
    runner.model.double()
    runner.make_train_state(4)
    rng = np.random.RandomState(31)
    batches = [{"partial": torch.from_numpy(rng.randn(2, 128, 3) * 0.3),
                "gt": torch.from_numpy(rng.randn(2, int(cfg.model.num_points), 3) * 0.3)} for _ in range(2)]
    noises = [torch.from_numpy(rng.randn(2, 64, 3)) for _ in range(2)]
    start = {k: v.clone() for k, v in runner.model.state_dict().items()}

    per_batch = []  # each batch's own gradient at the starting weights
    for batch, noise in zip(batches, noises):
        runner.model.load_state_dict(start)
        runner.model.train().zero_grad(set_to_none=True)
        ret = runner.model(batch["partial"], bn_momentum=runner.bnm_sched(0.0), noise=noise)
        sum(runner.model.loss(ret, batch["gt"], 0.0)).backward()
        per_batch.append({n: p.grad.numpy().copy() for n, p in runner.model.named_parameters()
                          if p.grad is not None})
    runner.model.load_state_dict(start)
    runner.model.zero_grad(set_to_none=True)

    first = runner.train_step(batches[0], 0.0, noise=noises[0])
    assert "grad_norm" not in first and runner.step == 1 and runner.optimizer.state_dict()["state"] == {}
    for n, p in runner.model.named_parameters():
        assert torch.equal(p, start[n]), n
    second = runner.train_step(batches[1], 0.25, noise=noises[1])
    assert runner.step == 2 and first["lr"] == second["lr"] == runner.lr_sched(0)

    names = [n for n, _ in runner.model.named_parameters()]
    with x64():
        params = {n: jnp.asarray(start[n].numpy()) for n in names}
        jcfg = jax_cfg("cfgs/PCN_models/AdaPoinTr-tiny-k2.yaml")
        tx, _, _ = jax_build_opt_sched(jcfg, 4, params)
        state = jax.jit(tx.init)(params)
        update = jax.jit(lambda g, s, p: (lambda u, s2: (jax.tree_util.tree_map(jnp.add, p, u), s2))(
            *tx.update(g, s, p)))
        for g in per_batch:
            jgrad = {n: jnp.asarray(g[n]) if n in g else jnp.zeros_like(params[n]) for n in names}
            params, state = update(jgrad, state, params)
    total = np.sqrt(sum(float(((per_batch[0][n] + per_batch[1][n]) ** 2).sum()) for n in per_batch[0]))
    np.testing.assert_allclose(float(second["grad_norm"]), total, rtol=1e-12)
    assert total > 10.0  # the summed gradient engages the clip
    moved = 0
    for n, p in runner.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=1e-12, atol=1e-14,
                                   err_msg=n)
        moved += not torch.equal(p, start[n])
    assert moved > 0.9 * len(per_batch[0])


def test_baselines_share_one_registry_entry_each():
    """The five baselines are ``Baseline`` classes listed once in
    ``BASELINES``; the model registry builds each by that name."""
    assert list(BASELINES) == ["FoldingNet", "PCN", "TopNet", "GRNet", "SnowFlakeNet"]
    assert set(BASELINES) <= set(MODELS.keys())
    for name, cls in BASELINES.items():
        assert issubclass(cls, Baseline) and cls.__name__ == name and cls.inputs == ("partial",)
    assert port_grnet.GRNet.loss is Baseline.loss


def test_grnet_refuses_random_eval_sampling():
    """``eval_sampling`` takes ``fixed`` or ``random`` and refuses anything
    else; ``random`` refuses an eval forward without a generator rather
    than draw from a hidden one."""
    cfg = cfg_from_yaml_file("cfgs/PCN_models/GRNet.yaml").model
    with torch.device("meta"):
        assert port_grnet.GRNet(cfg).eval_sampling == "fixed"
        cfg.eval_sampling = "random"
        assert port_grnet.GRNet(cfg).eval_sampling == "random"
        cfg.eval_sampling = "randomly"
        with pytest.raises(ValueError, match="eval_sampling"):
            port_grnet.GRNet(cfg)
    _, pcfg = configs("GRNet")
    pcfg.model.eval_sampling = "random"
    model = MODELS.build(pcfg.model, device="cpu", seed=0).eval()
    with pytest.raises(ValueError, match="generator"), torch.no_grad():
        model(torch.zeros(1, 128, 3))


def test_grnet_random_eval_sampling(one_torch_thread):
    """``eval_sampling: random`` against the JAX module in float64 at the
    small widths, both handed the same scores (JAX's, drawn from the
    'noise' key it is given; 1e-9 absolute); from the port's generator two
    requests of one seed are bit-equal, two seeds differ, and the shapes
    are the fixed mode's."""
    jcfg, pcfg = configs("GRNet")
    jcfg.model.eval_sampling = pcfg.model.eval_sampling = "random"
    B, n_in, _ = SMALL["GRNet"][1]
    x = np.random.RandomState(5).uniform(-0.45, 0.45, (B, n_in, 3))
    runner = JaxRunner(types.SimpleNamespace(tp=1), jcfg)
    module = runner.module
    key = jax.random.PRNGKey(9)
    with x64():
        xj = jnp.asarray(x)
        shapes = jax.eval_shape(lambda: module.init({"params": key, "noise": key}, xj, train=True))
        v = random_tree(dict(shapes), 29)
        variables = as_f64(v)
        scores = grnet_scores(module, variables, key, B, n_in + port_grnet.GRID**3)
        want = [np.asarray(o) for o in jax.jit(
            lambda v, x: module.apply(v, x, train=False, rngs={"noise": key}))(variables, xj)]
    model = MODELS.build(pcfg.model, device="cpu", seed=0).double().eval()
    model.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"], pcfg.model), strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = model(xt, noise=torch.from_numpy(scores))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9)
        draws = [model(xt, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    for a, b in zip(draws[0], draws[1]):
        assert torch.equal(a, b)
    assert not torch.equal(draws[0][0], draws[2][0])
    assert [tuple(t.shape) for t in draws[0]] == [tuple(t.shape) for t in got] == [
        (B, pcfg.model.num_pred // 8, 3), (B, pcfg.model.num_pred, 3)]


@pytest.mark.parametrize("before", [False, True])
def test_deterministic_cudnn_holds_the_flag_for_its_block(before):
    """``deterministic_cudnn`` sets cuDNN's deterministic flag for its
    block only, restores it after an exception too, and leaves cuDNN's
    other flags alone; ``resolve_device`` does not set it."""
    flags = torch.backends.cudnn
    saved = (flags.deterministic, flags.enabled, flags.benchmark, flags.allow_tf32)
    try:
        flags.deterministic = before
        others = (flags.enabled, flags.benchmark, flags.allow_tf32)
        with deterministic_cudnn():
            assert flags.deterministic and (flags.enabled, flags.benchmark, flags.allow_tf32) == others
        assert flags.deterministic is before
        with pytest.raises(RuntimeError), deterministic_cudnn():
            raise RuntimeError
        assert flags.deterministic is before
        resolve_device("cpu")
        assert flags.deterministic is before
    finally:
        flags.deterministic, flags.enabled, flags.benchmark, flags.allow_tf32 = saved
