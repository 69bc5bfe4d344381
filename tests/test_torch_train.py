"""The port's training slice as a whole against the JAX package, on the CPU.

One whole train step (forward in train mode, AdaPoinTr loss, backward, clip,
AdamW, BN statistics) on ``cfgs/PCN_models/AdaPoinTr-tiny.yaml`` in float64
on both sides, from the JAX package's canonical init carried across by the
port's converter, against ``Runner._train_step`` / ``build_opt_sched`` of
the JAX package; then a second step that starts from the JAX run's state,
optimizer moments included. The denoise jitter is fixed on both sides: the
JAX side's ``jitter_points`` is patched inside the fixture to add the
noise the port is handed (no file of the JAX package changes).

Tolerances (both frameworks in float64, sums in different orders): losses
1e-9 relative, every gradient 1e-8 of the global gradient norm, BN
statistics 1e-10, parameters after the step 1e-9 absolute where
``|grad| > GRAD_FLOOR`` (1e-9). The first AdamW step is sign-like
(``m / sqrt(v)`` is about +-1), so a parameter whose gradient is rounding
noise may step the other way: below the floor the parameters may differ by
2 lr.

The second half drives the runner through its entry point on the CPU.
"""

import contextlib
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imgadapointr_tpu.ops as jops
from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
from imgadapointr_tpu.tools.runner import Runner as JaxRunner
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import main as port_main
from imgadapointr_tpu_torch.tools import builder
from imgadapointr_tpu_torch.tools.convert import (
    _params_from_flax,
    adamw_state_from_optax,
    state_dict_from_flax,
)
from imgadapointr_tpu_torch.tools.runner import Runner
from imgadapointr_tpu_torch.utils.checkpoint import load_checkpoint
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from parity.param_source import init_variables
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

TINY = "cfgs/PCN_models/AdaPoinTr-tiny.yaml"
B, N_IN = 2, 256
STEPS_PER_EPOCH = 4
GRAD_FLOOR = 1e-9


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _adam_state(opt_state):
    (found,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return found


@pytest.fixture(scope="module")
def jax_run():
    """Two consecutive JAX train steps on fixed inputs, with the gradients
    of each; one jit compile serves both."""
    cfg = jax_cfg(TINY)
    rng = np.random.RandomState(21)
    batches = [{"partial": rng.randn(B, N_IN, 3) * 0.3,
                "gt": rng.randn(B, int(cfg.model.num_points), 3) * 0.3} for _ in range(2)]
    noises = [rng.randn(B, 64, 3) for _ in range(2)]
    epochs = [0.0, 1.0 / STEPS_PER_EPOCH]
    out = {"cfg": cfg, "batches": batches, "noises": noises, "epochs": epochs}
    patch = pytest.MonkeyPatch()
    with x64():
        variables = jax.jit(lambda: init_variables(cfg.model, "adapointr", batch=B, n_points=N_IN)[1])()
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), dict(variables))
        runner = JaxRunner(types.SimpleNamespace(tp=1), cfg)
        runner.tx, runner.lr_sched, runner.bnm_sched = jax_build_opt_sched(
            cfg, STEPS_PER_EPOCH, variables["params"])
        runner.steps_per_epoch = STEPS_PER_EPOCH
        state = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                 "opt_state": runner.tx.init(variables["params"]), "step": jnp.zeros((), jnp.int32)}
        key = jax.random.PRNGKey(0)

        def step_and_grads(state, batch, noise, epoch_f):
            # the model reads `ops.jitter_points` at trace time: hand it this step's noise
            patch.setattr(jops, "jitter_points",
                          lambda key, pc, std=0.01, clip=0.05: pc + jnp.clip(std * noise, -clip, clip))

            def loss(params):
                ret, _ = runner.module.apply(
                    {"params": params, "batch_stats": state["batch_stats"]}, batch["partial"],
                    train=True, bn_momentum=runner.bnm_sched(epoch_f),
                    rngs={"noise": key, "dropout": key}, mutable=["batch_stats"])
                sparse, dense = runner.spec.loss_fn(ret, batch["gt"], epoch_f)
                return sparse + dense

            return runner._train_step(state, batch, key, epoch_f), jax.grad(loss)(state["params"])

        try:
            fn = jax.jit(step_and_grads)
            out["states"] = [_np_tree(state)]
            for batch, noise, e in zip(batches, noises, epochs):
                jb = {k: jnp.asarray(v) for k, v in batch.items()}
                (state, metrics), grads = fn(state, jb, jnp.asarray(noise), jnp.asarray(e))
                out["states"].append(_np_tree(state))
                out.setdefault("metrics", []).append({k: float(v) for k, v in metrics.items()})
                out.setdefault("grads", []).append(_np_tree(grads))
        finally:
            patch.undo()
    return out


def _port_runner(jax_run, state, tmp_path):
    """The port's runner in float64 on the CPU, loaded with a JAX state's
    weights and BN statistics."""
    cfg = cfg_from_yaml_file(TINY)
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path))
    runner = Runner(args, cfg, logger="silent")
    runner.model.double()
    runner.make_train_state(STEPS_PER_EPOCH)
    sd = state_dict_from_flax(state["params"], state["batch_stats"], cfg.model)
    p64 = _params_from_flax(state["params"], cfg.model)  # the converter's float32 cast undone
    for k in sd:
        if k in p64:
            sd[k] = torch.from_numpy(np.array(p64[k], dtype=np.float64))
    bn = state["batch_stats"]["increase_dim_bn"]
    sd["increase_dim.1.running_mean"] = torch.from_numpy(np.array(bn["mean"], dtype=np.float64))
    sd["increase_dim.1.running_var"] = torch.from_numpy(np.array(bn["var"], dtype=np.float64))
    runner.model.load_state_dict(sd, strict=True)
    return runner, cfg


def _check_step(jax_run, i, runner, cfg):
    """Port step ``i`` (0 or 1) against the JAX run's."""
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batches"][i].items()}
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    got = runner.train_step(batch, jax_run["epochs"][i], noise=torch.from_numpy(jax_run["noises"][i]))
    want = jax_run["metrics"][i]
    for k in ("sparse_loss", "dense_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)

    # gradients: the port's are clipped in place, so clip the JAX ones alike
    norm = want["grad_norm"]
    coef = min(10.0 / (norm + 1e-6), 1.0)
    jgrads = _params_from_flax(jax_run["grads"][i], cfg.model)
    jparams = _params_from_flax(jax_run["states"][i + 1]["params"], cfg.model)
    lr = want["lr"]
    n_floor = 0
    for name, p in runner.model.named_parameters():
        if "query_ranking" in name or "encoder.norm" in name:
            # no gradient: untouched by the step (JAX: zero gradient, decay masked off)
            assert p.grad is None, name
            assert torch.equal(p, before[name]), name
            if name in jgrads:
                assert float(np.abs(jgrads[name]).max()) == 0.0
                np.testing.assert_array_equal(p.detach().numpy(), jparams[name])
            continue
        g, jg = p.grad.numpy(), jgrads[name] * coef
        assert float(np.abs(g - jg).max()) <= 1e-8 * norm, name
        live = np.abs(jg) > GRAD_FLOOR
        n_floor += int((~live).sum())
        diff = np.abs(p.detach().numpy() - jparams[name])
        assert float(diff[live].max(initial=0.0)) <= 1e-9, name
        assert float(diff.max()) <= 2.0 * lr + 1e-9, name
        assert not torch.equal(p, before[name]), name
    n_total = sum(p.numel() for p in runner.model.parameters())
    assert n_floor < 0.2 * n_total, f"{n_floor} of {n_total} entries under the gradient floor"

    bn = jax_run["states"][i + 1]["batch_stats"]["increase_dim_bn"]
    bn_port = runner.model.increase_dim[1]
    for got_s, want_s in ((bn_port.running_mean, bn["mean"]), (bn_port.running_var, bn["var"])):
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                                   atol=1e-10 * float(np.abs(want_s).max()))
    return got


def test_train_step_matches_jax_from_converted_weights(jax_run, tmp_path):
    runner, cfg = _port_runner(jax_run, jax_run["states"][0], tmp_path)
    assert runner.step == 0 and runner.optimizer.state_dict()["state"] == {}
    got = _check_step(jax_run, 0, runner, cfg)
    assert runner.step == 1 and int(jax_run["states"][1]["step"]) == 1
    assert got["lr"] == 5e-4 and float(got["total_loss"]) > 0
    # AdamW holds moments for the parameters with a gradient only
    names = {id(p): n for n, p in runner.model.named_parameters()}
    with_state = {names[id(p)] for p in runner.optimizer.state}
    assert with_state and not any("query_ranking" in n or "encoder.norm" in n for n in with_state)


def test_train_step_continues_jax_run_from_converted_optimizer_state(jax_run, tmp_path):
    """Step 2 from the JAX run's state after step 1: weights, BN
    statistics and the AdamW moments and count, carried across."""
    state = jax_run["states"][1]
    runner, cfg = _port_runner(jax_run, state, tmp_path)
    adam = _adam_state(state["opt_state"])
    sd = adamw_state_from_optax(adam.mu, adam.nu, int(adam.count), cfg.model,
                                runner.model, runner.optimizer)
    runner.optimizer.load_state_dict(sd)
    runner.step = int(state["step"])
    assert runner.step == 1 and all(float(s["step"]) == 1.0 for s in sd["state"].values())
    _check_step(jax_run, 1, runner, cfg)
    # second step: the update is no longer sign-like, and the moments agree
    adam2 = _adam_state(jax_run["states"][2]["opt_state"])
    mu2 = _params_from_flax(adam2.mu, cfg.model)
    nu2 = _params_from_flax(adam2.nu, cfg.model)
    for name, p in runner.model.named_parameters():
        if p in runner.optimizer.state:
            st = runner.optimizer.state[p]
            assert float(st["step"]) == 2.0
            np.testing.assert_allclose(st["exp_avg"].numpy(), mu2[name], rtol=0,
                                       atol=1e-9 * jax_run["metrics"][1]["grad_norm"], err_msg=name)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu2[name], rtol=0,
                                       atol=1e-9 * jax_run["metrics"][1]["grad_norm"] ** 2, err_msg=name)


def test_build_opt_sched_groups_and_limits():
    cfg = cfg_from_yaml_file(TINY)
    runner = Runner(types.SimpleNamespace(device="cpu", seed=0), cfg, logger="silent")
    opt, lr_step, bnm = builder.build_opt_sched(cfg, 10, runner.model)
    decay, no_decay = opt.param_groups
    assert decay["weight_decay"] == 5e-4 and no_decay["weight_decay"] == 0.0
    assert all(p.ndim > 1 for p in decay["params"]) and all(p.ndim <= 1 for p in no_decay["params"])
    assert len(decay["params"]) + len(no_decay["params"]) == len(list(runner.model.parameters()))
    assert lr_step(0) == 5e-4 and lr_step(10) == 5e-4 * 0.9 ** (1 / 21) and bnm(0.0) == 0.9
    for key, value in (("optimizer", {"type": "SGD", "kwargs": {"lr": 0.1}}), ("step_per_update", 2)):
        bad = cfg_from_yaml_file(TINY)
        bad[key] = value
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            builder.build_opt_sched(bad, 10, runner.model)


def test_train_step_refuses_a_gradient_on_query_ranking(monkeypatch):
    """The zero-gradient subtree is asserted, not zeroed by hand: a model
    that pulls ``query_ranking`` into the graph fails the step."""
    cfg = cfg_from_yaml_file(TINY)
    runner = Runner(types.SimpleNamespace(device="cpu", seed=0), cfg, logger="silent")
    runner.make_train_state(2)
    g = torch.Generator().manual_seed(0)
    batch = {"partial": torch.randn(2, N_IN, 3, generator=g) * 0.3,
             "gt": torch.randn(2, int(cfg.model.num_points), 3, generator=g) * 0.3}
    out = runner.train_step(batch, 0.0)
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in out.values())
    ranking = runner.model.base_model.query_ranking
    forward = type(runner.model).forward

    def leaky(self, xyz, **kw):
        ret = forward(self, xyz, **kw)
        return (ret[0] + 0.0 * ranking(ret[0]).sum(),) + tuple(ret[1:])

    monkeypatch.setattr(type(runner.model), "forward", leaky)
    with pytest.raises(RuntimeError, match="query_ranking"):
        runner.train_step(batch, 0.0)


# ------------------------------------------------------------ the entry point


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A working directory of its own that holds ``cfgs/`` (the configs'
    ``_base_`` includes, the taxonomy names and ``experiments/`` are all
    relative to the working directory)."""
    (tmp_path / "cfgs").symlink_to(pathlib.Path(__file__).resolve().parent.parent / "cfgs")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _main(*extra):
    return port_main.main([
        "--config", TINY, "--exp_name", "run", "--synthetic",
        "--syn_train_len", "16", "--device", "cpu", "--num_workers", "0", "--val_freq", "1",
        *extra,
    ])


def test_main_trains_resumes_and_tests_on_the_cpu(run_dir, capfd, one_torch_thread):
    """2 epochs of 2 steps with validation, then ``--resume`` (nothing left
    to train: the parameters are the checkpoint's, bit for bit), then
    ``--test`` on the best checkpoint."""
    runner = _main()
    exp = run_dir / "experiments" / "AdaPoinTr-tiny" / "PCN_models" / "run"
    for name in ("ckpt-last.pth", "ckpt-best.pth", "ckpt-epoch-001.pth", "config.yaml"):
        assert (exp / name).exists(), name
    assert runner.step == 4
    log = capfd.readouterr().err
    assert "[Validation] EPOCH: 1" in log and "[Training] EPOCH: 1" in log

    resumed = _main("--resume")
    assert "Resumed from epoch 2" in capfd.readouterr().err
    assert resumed.step == 4
    for (n, a), (_, b) in zip(runner.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    want, got = runner.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"] and want["state"].keys() == got["state"].keys()
    for k, st in want["state"].items():
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[field], got["state"][k][field]), (k, field)
    meta = load_checkpoint(str(exp / "ckpt-last.pth"), resumed.model)
    assert meta["epoch"] == 1 and meta["step"] == 4 and set(meta["best_metrics"]) == {
        "F-Score", "CDL1", "CDL2", "EMDistance"}

    scores = _main("--test", "--ckpts", str(exp / "ckpt-best.pth"))
    table = capfd.readouterr().err
    assert "TEST RESULTS" in table and "Overall" in table and "EMD on" in table
    assert set(scores) == {"F-Score", "CDL1", "CDL2", "EMDistance"}
    assert 0.0 <= scores["F-Score"] <= 1.0 and scores["CDL1"] > 0 and scores["CDL2"] > 0
    assert scores["EMDistance"] > 0.0
    no_emd = _main("--test", "--ckpts", str(exp / "ckpt-best.pth"), "--no_emd")
    assert "EMD off (--no_emd)" in capfd.readouterr().err
    assert no_emd["EMDistance"] == 0.0 and no_emd["CDL1"] == scores["CDL1"]
    with pytest.raises(ValueError, match="--ckpts"):
        _main("--test")


def test_main_warm_starts_from_a_checkpoint(run_dir, capfd):
    """``--start_ckpts`` loads the weights only: fresh optimizer and step."""
    cfg = cfg_from_yaml_file(TINY)
    donor = Runner(types.SimpleNamespace(device="cpu", seed=7), cfg, logger="silent")
    ckpt = run_dir / "donor.pth"
    torch.save({"base_model": donor.model.state_dict()}, ckpt)
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(run_dir))
    fresh = Runner(args, cfg, logger="silent")
    assert not torch.equal(fresh.model.reduce_map.weight, donor.model.reduce_map.weight)
    fresh.load_weights(str(ckpt))
    for (n, a), (_, b) in zip(donor.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    with pytest.raises(SystemExit):
        _main("--resume", "--start_ckpts", str(ckpt))
    capfd.readouterr()
