"""The port reads the JAX package's checkpoints, on the CPU.

- ``utils/flax_msgpack.py`` decodes what ``flax.serialization.to_bytes``
  writes equal to ``flax.serialization.msgpack_restore``, leaf for leaf and
  bit for bit: a train state the JAX package's own ``save_checkpoint``
  wrote, a ``bfloat16`` leaf (widened to float32, exactly), numpy scalars
  and flax's chunked arrays (``MAX_CHUNK_SIZE`` lowered in the test).
- ``--ckpts`` and ``--start_ckpts`` from a ``.ckpt`` (a path, a bare
  prefix, a name inside the experiment directory) on ``AdaPoinTr-tiny.yaml``:
  the port's ``validate`` equals the JAX package's ``validate`` on the same
  checkpoint and clouds, in float64, to 1e-9 relative.
- ``--resume`` of a JAX run: from the ``ckpt-last.ckpt`` the JAX package
  saved after one step (AdamW, Adam with coupled L2, SGD with momentum: the
  test swaps the config's ``optimizer``), the port's next step gives the
  losses, gradient norm, learning rate, BN statistics and parameters of the
  JAX run's next step, in float64: losses and norm to 1e-9 relative,
  parameters to 1e-9 absolute where the JAX gradient is above
  ``GRAD_FLOOR`` (an Adam update of a gradient that is rounding noise may
  take either sign: there the two may differ by 2 lr). The JAX steps are
  the JAX runner's ``_train_step`` taken apart (the model's train-mode
  apply with ``bnm_sched``, ``spec.loss_fn``, ``tx.update``,
  ``optax.apply_updates``, ``lr_sched(step)``), so that one jitted
  gradient serves the three optimizers; the denoise jitter is fixed on both
  sides by patching ``jitter_points`` inside the traced function, as
  ``tests/test_torch_train.py`` does.
"""

import contextlib
import copy
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import imgadapointr_tpu.ops as jops
from imgadapointr_tpu.tools import runner as jax_runner
from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
from imgadapointr_tpu.utils import checkpoint as jax_checkpoint
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.tools.convert import _params_from_flax, state_dict_from_flax
from imgadapointr_tpu_torch.utils import flax_msgpack
from imgadapointr_tpu_torch.utils.checkpoint import load_jax_checkpoint, resolve_jax_checkpoint
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from parity.param_source import init_variables
from test_torch_entry import small_synthetic  # noqa: F401  (a fixture)
from test_torch_seg import one_torch_thread, random_tree  # noqa: F401  (a fixture)

TINY = "cfgs/PCN_models/AdaPoinTr-tiny.yaml"
B, N_IN = 2, 256
GRAD_FLOOR = 1e-9
OPTIMIZERS = {  # the config's optimizer block for each case
    "AdamW": {"type": "AdamW", "kwargs": {"lr": 0.0005, "weight_decay": 0.0005}},
    "Adam": {"type": "Adam", "kwargs": {"lr": 0.0005, "weight_decay": 0.0005}},
    "SGD": {"type": "SGD", "kwargs": {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.0005}},
}


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


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _with_optimizer(cfg, name: str):
    cfg = copy.deepcopy(cfg)
    cfg.optimizer = copy.deepcopy(OPTIMIZERS[name])
    return cfg


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """For each optimizer, a JAX run of two steps (one step an epoch) from
    one numpy-seeded float64 state: ``ckpt-last.ckpt`` saved by the JAX
    package after the first step (epoch 0), and the second step's results."""
    cfg = jax_cfg(TINY)
    shapes = jax.eval_shape(lambda: init_variables(cfg.model, "adapointr", batch=B, n_points=N_IN)[1])
    variables = _f64({k: _np_tree(dict(v)) for k, v in random_tree(dict(shapes), 3).items()})
    rng = np.random.RandomState(21)
    batches = [{"partial": rng.randn(B, N_IN, 3) * 0.3,
                "gt": rng.randn(B, int(cfg.model.num_points), 3) * 0.3} for _ in range(2)]
    noises = [rng.randn(B, 64, 3) for _ in range(2)]
    epochs = [0.0, 1.0]
    out = {"cfg": cfg, "variables": variables, "batches": batches, "noises": noises, "epochs": epochs,
           "runs": {}}
    patch = pytest.MonkeyPatch()
    with x64():
        runner = jax_runner.Runner(types.SimpleNamespace(tp=1), cfg)
        key = jax.random.PRNGKey(0)

        def loss_and_grads(params, batch_stats, batch, noise, epoch_f, bnm):
            # the model reads `ops.jitter_points` at trace time: hand it this step's noise
            patch.setattr(jops, "jitter_points",
                          lambda key, pc, std=0.01, clip=0.05: pc + jnp.clip(std * noise, -clip, clip))

            def loss(params):
                ret, upd = runner.module.apply(
                    {"params": params, "batch_stats": batch_stats}, batch["partial"],
                    train=True, bn_momentum=bnm, rngs={"noise": key, "dropout": key},
                    mutable=["batch_stats"])
                sparse, dense = runner.spec.loss_fn(ret, batch["gt"], epoch_f)
                return sparse + dense, (sparse, dense, upd["batch_stats"])

            (total, (sparse, dense, new_bs)), grads = jax.value_and_grad(loss, has_aux=True)(params)
            return {"sparse_loss": sparse, "dense_loss": dense, "total_loss": total,
                    "grad_norm": optax.global_norm(grads)}, new_bs, grads

        try:
            fn = jax.jit(loss_and_grads)
            jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
            first = None  # step 1 starts from the same state for every optimizer
            for name in OPTIMIZERS:
                ocfg = _with_optimizer(cfg, name)
                tx, lr_sched, bnm_sched = jax_build_opt_sched(ocfg, 1, variables["params"])
                state = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                         "opt_state": tx.init(variables["params"]), "step": jnp.zeros((), jnp.int32)}
                run = {"cfg": ocfg}
                update = jax.jit(tx.update)  # eager, it would compile each leaf's ops one by one
                for i in range(2):
                    if i == 0 and first is not None:
                        metrics, new_bs, grads = first
                    else:
                        metrics, new_bs, grads = fn(state["params"], state["batch_stats"], jb[i],
                                                    jnp.asarray(noises[i]), jnp.asarray(epochs[i]),
                                                    bnm_sched(epochs[i]))
                        first = first or (metrics, new_bs, grads)
                    updates, new_opt = update(grads, state["opt_state"], state["params"])
                    lr = float(lr_sched(state["step"]))
                    state = {"params": optax.apply_updates(state["params"], updates), "batch_stats": new_bs,
                             "opt_state": new_opt, "step": state["step"] + 1}
                    if i == 0:
                        exp = tmp_path_factory.mktemp(f"jax_{name}")
                        jax_checkpoint.save_checkpoint(state, None, {"CDL1": 1.5}, 0, "ckpt-last", str(exp))
                        run["exp"] = exp
                    else:
                        run["metrics"] = {k: float(v) for k, v in metrics.items()} | {"lr": lr}
                        run["grads"] = _np_tree(grads)
                        run["after"] = _np_tree(state)
                out["runs"][name] = run
        finally:
            patch.undo()
    return out


# ------------------------------------------------------------ the reader


def _assert_same_tree(got, want, path="") -> int:
    """Leaf for leaf: the same keys, types, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        return sum(_assert_same_tree(got[k], want[k], f"{path}/{k}") for k in want)
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8)), path
    else:
        assert got == want, path
    return 1


def test_reader_matches_flax_on_a_jax_train_state(jax_runs):
    """The JAX package's ``ckpt-last.ckpt`` (params, batch_stats, the
    AdamW ``opt_state`` after a step, step) and its sidecar."""
    path = str(jax_runs["runs"]["AdamW"]["exp"] / "ckpt-last.ckpt")
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    tree, meta = load_jax_checkpoint(path)
    n = _assert_same_tree(tree, want)
    assert set(tree) == {"params", "batch_stats", "opt_state", "step"} and int(tree["step"]) == 1
    assert n > 3 * len(jax.tree_util.tree_leaves(want["params"]))  # params, mu, nu
    assert meta == {"epoch": 0, "metrics": None, "best_metrics": {"CDL1": 1.5}}


def test_reader_bfloat16_scalars_chunks_and_refusals(monkeypatch):
    rng = np.random.RandomState(0)
    bf = jnp.asarray(rng.randn(5, 7), jnp.bfloat16)
    tree = {"bf": bf, "f32": np.float32(1.25), "i64": np.int64(-3), "u8": np.arange(6, dtype=np.uint8),
            "big": rng.randn(33, 5), "ints": [1, -200, 70000, 2**40], "s": "ckpt", "none": None, "t": True,
            "f": 0.5, "empty": {}, "zero_d": np.array(4.0)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)  # chunk every array over 64 bytes
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.msgpack_restore(data)
    # bfloat16, which numpy cannot name, is widened exactly to float32
    wbf, gbf = np.asarray(want.pop("bf")), got.pop("bf")
    assert gbf.dtype == np.float32 and gbf.shape == wbf.shape
    assert np.array_equal(gbf.view(np.uint32) >> 16, wbf.view(np.uint16))
    assert not (gbf.view(np.uint32) & 0xFFFF).any()
    _assert_same_tree(got, want)
    with pytest.raises(ValueError, match="complex"):
        flax_msgpack.msgpack_restore(serialization.msgpack_serialize({"c": complex(1.0, 2.0)}))
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.msgpack_restore(data + b"\x00")


# ------------------------------------------------------ --ckpts / --start_ckpts


def _float64_runner(cfg, tmp_path, name="AdamW", **args):
    runner = port_runner.Runner(types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path),
                                                      **args), cfg, logger="silent")
    runner.model.double()
    return runner


def test_ckpts_and_start_ckpts_read_a_jax_checkpoint(jax_runs, tmp_path, one_torch_thread):
    """Every spelling ``--ckpts`` / ``--start_ckpts`` take loads the same
    weights; ``validate`` on them equals the JAX package's ``validate`` on
    the same checkpoint and clouds (float64, 1e-9 relative)."""
    exp = jax_runs["runs"]["AdamW"]["exp"]
    cfg = cfg_from_yaml_file(TINY)
    runner = _float64_runner(cfg, tmp_path)
    runner.load_weights(str(exp / "ckpt-last.ckpt"))
    want = {k: v.clone() for k, v in runner.model.state_dict().items()}
    tree, _ = load_jax_checkpoint(str(exp / "ckpt-last.ckpt"))
    p64 = _params_from_flax(tree["params"], cfg.model)
    assert all(torch.equal(want[k], torch.from_numpy(np.asarray(v, np.float64))) for k, v in p64.items())
    for spelling, in_exp in ((str(exp / "ckpt-last"), None), ("ckpt-last", str(exp)),
                             ("ckpt-last.ckpt", str(exp))):
        other = _float64_runner(cfg, in_exp or tmp_path)
        other.load_weights(spelling)
        assert all(torch.equal(v, want[k]) for k, v in other.model.state_dict().items()), spelling
    with pytest.raises(FileNotFoundError, match="no JAX checkpoint"):
        resolve_jax_checkpoint("ckpt-best", str(exp))

    rng = np.random.RandomState(4)
    samples = [(tax, f"m{i}", {"partial": rng.randn(1, N_IN, 3) * 0.3,
                               "gt": rng.randn(1, int(cfg.model.num_points), 3) * 0.3})
               for i, tax in enumerate(["02691156", "02691156", "03001627"])]
    got = port_runner.validate(runner, [([t], [m], {k: torch.from_numpy(v) for k, v in b.items()})
                                        for t, m, b in samples], 0, "silent")
    with x64():
        jcfg = jax_runs["runs"]["AdamW"]["cfg"]
        jrun = jax_runner.Runner(types.SimpleNamespace(tp=1), jcfg)
        template = {k: jax_runs["variables"][k] for k in ("params", "batch_stats")}
        state, _ = jax_checkpoint.load_checkpoint(template, "ckpt-last", str(exp))
        want_m = jax_runner.validate(jrun, jrun.shard_state(state), [([t], [m], b) for t, m, b in samples],
                                     0, None, types.SimpleNamespace(), jcfg)
    for k, v in want_m.state_dict().items():
        np.testing.assert_allclose(got.state_dict()[k], v, rtol=1e-9, atol=0, err_msg=k)


# -------------------------------------------------------------- --resume


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_continues_a_jax_run(jax_runs, name, one_torch_thread):
    """The port continues the JAX run from its ``ckpt-last.ckpt`` (there
    is no ``ckpt-last.pth``): the next step equals the JAX run's."""
    run = jax_runs["runs"][name]
    cfg = _with_optimizer(cfg_from_yaml_file(TINY), name)
    runner = _float64_runner(cfg, run["exp"], resume=True)
    runner.make_train_state(1)
    path = port_runner.resume_path(str(run["exp"]))
    assert path.endswith("ckpt-last.ckpt")
    meta = runner.resume(path)
    assert (meta["epoch"], meta["best_metrics"], runner.step) == (0, {"CDL1": 1.5}, 1)
    state = runner.optimizer.state_dict()["state"]
    assert state and all(("momentum_buffer" in s) == (name == "SGD") for s in state.values())

    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    got = runner.train_step({k: torch.from_numpy(v) for k, v in jax_runs["batches"][1].items()},
                            jax_runs["epochs"][1], noise=torch.from_numpy(jax_runs["noises"][1]))
    want = run["metrics"]
    for k in ("sparse_loss", "dense_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)
    jgrads = _params_from_flax(run["grads"], cfg.model)
    jparams = _params_from_flax(run["after"]["params"], cfg.model)
    lr = want["lr"]
    for n, p in runner.model.named_parameters():
        if p.grad is None:  # no gradient: untouched, as in the JAX run (zero gradient, no decay)
            assert torch.equal(p, before[n]), n
            continue
        diff = np.abs(p.detach().numpy() - jparams[n])
        live = np.abs(jgrads[n]) > GRAD_FLOOR
        assert float(diff[live].max(initial=0.0)) <= 1e-9, n
        assert float(diff.max()) <= (2.0 * lr if name != "SGD" else 0.0) + 1e-9, n
    bn = run["after"]["batch_stats"]["increase_dim_bn"]
    bn_port = runner.model.increase_dim[1]
    for got_s, want_s in ((bn_port.running_mean, bn["mean"]), (bn_port.running_var, bn["var"])):
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-10 * float(np.abs(want_s).max()))


def test_resume_through_main_from_a_jax_experiment(jax_runs, tmp_path, monkeypatch, small_synthetic,
                                                   one_torch_thread):
    """``main --resume`` on an experiment directory that holds the JAX
    run's ``ckpt-last.ckpt``, its sidecar and the ``config.yaml`` copy both
    packages save: the run continues at epoch 1 from its step and weights
    and then saves the port's own ``.pth``."""
    from imgadapointr_tpu_torch import main as port_main

    (tmp_path / "cfgs").symlink_to(__import__("pathlib").Path(__file__).resolve().parent.parent / "cfgs")
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "experiments" / "AdaPoinTr-tiny" / "PCN_models" / "run"
    exp.mkdir(parents=True)
    src = jax_runs["runs"]["AdamW"]["exp"]
    for f in ("ckpt-last.ckpt", "ckpt-last.ckpt.json"):
        (exp / f).write_bytes((src / f).read_bytes())
    (exp / "config.yaml").write_text((tmp_path / TINY).read_text())
    meta = json.loads((exp / "ckpt-last.ckpt.json").read_text())
    assert meta["epoch"] == 0
    runner = port_main.main(["--config", TINY, "--exp_name", "run", "--synthetic", "--syn_train_len", "2",
                             "--device", "cpu", "--num_workers", "0", "--resume"])
    assert runner.step == 1 + 1  # the JAX step, then epoch 1's one batch
    assert (exp / "ckpt-last.pth").exists() and (exp / "ckpt-epoch-001.pth").exists()
    assert port_runner.resume_path(str(exp)).endswith(".pth")
