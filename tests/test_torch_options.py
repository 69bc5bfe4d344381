"""The model options no shipped config sets, in the port against the JAX
package, on the CPU.

- ``options_config``: the tiny AdaPoinTr with the ``pn`` encoder, the
  ``fold`` head, 'onebyone' in the encoder and both decoder halves (one
  decoder block with 'deform' cross attention), LayerScale and the three
  rates; numpy-seeded weights of the init's ``jax.eval_shape`` through
  ``tools/convert.py`` (LayerScale's ``gamma`` drawn like a bias).
- Eval forward with the rates at 0.1 (eval ignores them) and one whole
  train step with the rates at 0 against the JAX runner, in float64:
  clouds 1e-9 absolute; losses and gradient norm 1e-9 relative, every
  gradient 1e-8 of the norm, parameters after the step 1e-9 where the JAX
  gradient is above ``GRAD_FLOOR`` (as ``tests/test_torch_deform.py``).
- The same train step with the rates at 0.1 on the same masks: JAX's
  threefry masks cannot be drawn by the port, so ``jax.random.bernoulli``
  (every flax ``Dropout`` and the JAX ``DropPath`` draw through it) is
  patched, in this process only, to hand out masks from a numpy queue in
  the order it is called, and the port's ``nn.layers.keep_mask`` to read
  the same queue; every mask's shape must match in order. Same tolerances.
- The port's own masks: the kept share within a 6-sigma binomial band,
  DropPath's whole rows, the 1/keep scale, no draw at rate 0 or in eval
  mode (the generator's state after a shipped config's train forward is
  the jitter's draw alone).
- The resume repair on ``AdaPoinTr-tiny-k2.yaml`` in float64: a checkpoint
  saved between the two batches of an update, the port's ``.pth`` and the
  JAX package's ``.ckpt`` of an ``optax.MultiSteps`` state, resumes into
  the uninterrupted run's update (the port's: bit-equal; JAX's next step:
  as above).
- ``square_distance``, ``gather_points`` and ``ball_query`` against the JAX
  ops; the strict loads of the options tree.
"""

import collections
import contextlib
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imgadapointr_tpu.ops as jops
from imgadapointr_tpu.models.build import build_model_spec
from imgadapointr_tpu.tools import runner as jax_runner
from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
from imgadapointr_tpu.utils import checkpoint as jax_checkpoint
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.nn import layers
from imgadapointr_tpu_torch.tools.builder import ZERO_GRAD_PARAM_MARKERS
from imgadapointr_tpu_torch.tools.convert import _mapping, _params_from_flax, state_dict_from_flax
from imgadapointr_tpu_torch.tools.runner import Runner
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from parity.param_source import init_variables
from test_torch_seg import one_torch_thread, random_tree  # noqa: F401  (a fixture)

TINY = "cfgs/PCN_models/AdaPoinTr-tiny.yaml"
TINY_K2 = "cfgs/PCN_models/AdaPoinTr-tiny-k2.yaml"
B, N_IN, N_GT = 2, 256, 1024
STEPS_PER_EPOCH = 4
GRAD_FLOOR = 1e-9
ATOL = 1e-9
RATE = 0.1


def options_config(cfg, rate: float = 0.0):
    """``cfg`` (the tiny AdaPoinTr, either package's loader) with every
    option on: ``pn``, ``fold`` (64 points a query), 'onebyone'
    everywhere, LayerScale and ``rate`` for dropout, attention dropout and
    DropPath; 32 queries keep the folds small, and the second decoder
    block's cross half is 'attn-deform' so that a deformable module's
    dropout and its 'onebyone' branch run too."""
    m = cfg.model
    m.encoder_type, m.decoder_type, m.num_query = "pn", "fold", 32
    m.encoder_config.combine_style = "onebyone"
    m.decoder_config.self_attn_combine_style = "onebyone"
    m.decoder_config.cross_attn_combine_style = "onebyone"
    m.decoder_config.cross_attn_block_style_list = ["attn-graph", "attn-deform"]
    for c in (m.encoder_config, m.decoder_config):
        c.init_values = 1e-5
        c.drop_rate = c.attn_drop_rate = c.drop_path_rate = rate
    return cfg


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
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _is_zero_grad(name: str) -> bool:
    return any(m in name for m in ZERO_GRAD_PARAM_MARKERS) or "encoder.norm" in name


def _variables(cfg, seed: int) -> dict:
    shapes = jax.eval_shape(lambda: init_variables(cfg.model, "adapointr", batch=B, n_points=N_IN)[1])
    return {k: _np_tree(dict(v)) for k, v in random_tree(dict(shapes), seed).items()}


def _port_model(pcfg, variables):
    model = build_model(pcfg.model, device="cpu", dtype=torch.float64)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg.model)
    p64 = _params_from_flax(variables["params"], pcfg.model)  # undo the float32 cast
    sd.update({k: torch.from_numpy(np.array(v, dtype=np.float64)) for k, v in p64.items()})
    model.load_state_dict(sd, strict=True)
    return model


class MaskQueue:
    """Masks drawn by numpy in the order JAX asks for them, handed to the
    port in the same order."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.masks = []
        self.queue = collections.deque()

    def jax_bernoulli(self, key, p=0.5, shape=None, mode=None):
        mask = self.rng.uniform(size=tuple(shape)) < float(p)
        self.masks.append((float(p), mask))
        return jnp.asarray(mask)

    def port_keep_mask(self, shape, keep, generator, device):
        p, mask = self.queue.popleft()
        assert tuple(shape) == mask.shape and keep == p, (tuple(shape), mask.shape, keep, p)
        return torch.from_numpy(mask).to(device)


def _jax_step(cfg, variables, batch, noise, masks: MaskQueue | None):
    """One JAX runner train step (its ``_train_step``, jitted) on fixed
    inputs, float64; the gradients handed out of the optimizer."""
    patch = pytest.MonkeyPatch()
    with x64():
        v64 = _f64(variables)
        runner = jax_runner.Runner(types.SimpleNamespace(tp=1), cfg)
        tx, runner.lr_sched, runner.bnm_sched = jax_build_opt_sched(cfg, STEPS_PER_EPOCH, v64["params"])
        runner.tx = optax.GradientTransformation(
            lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
            lambda g, s, p=None: (lambda u, ns: (u, (ns, g)))(*tx.update(g, s[0], p)))
        runner.steps_per_epoch = STEPS_PER_EPOCH
        state = {"params": v64["params"], "batch_stats": v64["batch_stats"],
                 "opt_state": runner.tx.init(v64["params"]), "step": jnp.zeros((), jnp.int32)}
        patch.setattr(jops, "jitter_points",
                      lambda key, pc, std=0.01, clip=0.05: pc + jnp.clip(std * jnp.asarray(noise), -clip, clip))
        if masks is not None:
            patch.setattr(jax.random, "bernoulli", masks.jax_bernoulli)
        try:
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            new_state, metrics = jax.jit(runner._train_step, static_argnums=3)(
                state, jb, jax.random.PRNGKey(0), 0.0)
        finally:
            patch.undo()
    return {"before": _np_tree(state), "after": _np_tree(new_state),
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": _np_tree(new_state["opt_state"][1])}


def _assert_step_matches(runner, pcfg, got, want, before):
    for k in ("sparse_loss", "dense_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), want["metrics"][k], rtol=1e-9, err_msg=k)
    norm = want["metrics"]["grad_norm"]
    coef = min(10.0 / (norm + 1e-6), 1.0)
    jgrads = _params_from_flax(want["grads"], pcfg.model)
    jparams = _params_from_flax(want["after"]["params"], pcfg.model)
    checked = 0
    for name, p in runner.model.named_parameters():
        if _is_zero_grad(name):
            assert p.grad is None and torch.equal(p, before[name]), name
            continue
        g, jg = p.grad.numpy(), jgrads[name] * coef
        assert float(np.abs(g - jg).max()) <= 1e-8 * norm, name
        live = np.abs(jg) > GRAD_FLOOR
        diff = np.abs(p.detach().numpy() - jparams[name])
        assert float(diff[live].max(initial=0.0)) <= 1e-9, name
        checked += 1
    return checked


@pytest.fixture(scope="module")
def opts():
    """(jax config, port config, numpy variables, batch, noise) of the
    options model with the rates at 0."""
    cfg = options_config(jax_cfg(TINY))
    rng = np.random.RandomState(31)
    batch = {"partial": rng.randn(B, N_IN, 3) * 0.3, "gt": rng.randn(B, N_GT, 3) * 0.3}
    return cfg, options_config(cfg_from_yaml_file(TINY)), _variables(cfg, 17), batch, rng.randn(B, 64, 3)


def _port_runner(pcfg, variables, tmp_path):
    runner = Runner(types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path)),
                    pcfg, logger="silent")
    runner.model = _port_model(pcfg, variables)
    runner.make_train_state(STEPS_PER_EPOCH)
    return runner


def test_options_tree_loads_strictly(opts):
    _, pcfg, variables, _, _ = opts
    model = build_model(pcfg.model, device="cpu")
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg.model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    keys = {k for k, *_ in _mapping(pcfg.model)}
    emb = "base_model.grouper.embedding"
    assert {f"{emb}.first_conv.0.weight", f"{emb}.first_conv.1.running_var", f"{emb}.second_conv.0.weight",
            f"{emb}.second_conv.3.bias"} <= keys
    assert model.state_dict()[f"{emb}.second_conv.0.weight"].shape == (512, 512, 1)
    assert {"decode_head.folding1.0.weight", "decode_head.folding2.4.running_mean",
            "decode_head.folding2.6.weight"} <= keys
    assert model.state_dict()["decode_head.folding1.0.weight"].shape == (256, 2 + 192, 1)
    enc0, dec1 = "base_model.encoder.blocks.blocks.0", "base_model.decoder.blocks.blocks.1"
    assert {f"{enc0}.norm3.weight", f"{enc0}.ls3.gamma", f"{dec1}.norm_q_2.bias", f"{dec1}.ls5.gamma"} <= keys
    assert f"{enc0}.merge_map.weight" not in keys
    # the encoder's second block holds one kind of attention: no third branch
    assert "base_model.encoder.blocks.blocks.1.ls3.gamma" not in keys
    assert len(model._stochastic) == 0  # the rates are 0: no layer can draw


def test_options_eval_forward_matches_jax_fp64(opts):
    cfg, pcfg, variables, batch, _ = opts
    cfg, pcfg = options_config(copy.deepcopy(cfg), RATE), options_config(copy.deepcopy(pcfg), RATE)
    x = batch["partial"]
    with x64():
        spec = build_model_spec(cfg.model)
        jc, jf = jax.jit(lambda v, x: spec.module.apply(v, x, train=False))(_f64(variables), jnp.asarray(x))
    model = _port_model(pcfg, variables)
    assert len(model._stochastic) > 0  # the rates are set, and eval mode ignores them
    with torch.inference_mode():
        coarse, fine = model(torch.from_numpy(x))
    assert coarse.shape == (B, 32, 3) and fine.shape == (B, 32 * 64, 3)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(fine.numpy(), np.asarray(jf), rtol=0, atol=ATOL)


def test_options_train_step_matches_jax_fp64(opts, tmp_path, one_torch_thread):
    cfg, pcfg, variables, batch, noise = opts
    want = _jax_step(cfg, variables, batch, noise, None)
    runner = _port_runner(pcfg, variables, tmp_path)
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    got = runner.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0,
                            noise=torch.from_numpy(noise))
    assert _assert_step_matches(runner, pcfg, got, want, before) > 100


def test_options_train_step_with_dropout_matches_jax_on_the_same_masks(opts, tmp_path, monkeypatch,
                                                                        one_torch_thread):
    cfg, pcfg, variables, batch, noise = opts
    cfg, pcfg = options_config(copy.deepcopy(cfg), RATE), options_config(copy.deepcopy(pcfg), RATE)
    masks = MaskQueue(5)
    want = _jax_step(cfg, variables, batch, noise, masks)
    # attention (2) and MLP (2) dropout of every attention and MLP, DropPath
    # on each branch past block 0, the deformable module's output: 4 + 6
    # in the encoder, 6 + 11 in the decoder
    assert len(masks.masks) == 27
    assert {m.shape for _, m in masks.masks} >= {(B, 1, 1), (B, 6, 96, 96), (B, 96, 384)}
    masks.queue.extend(masks.masks)
    runner = _port_runner(pcfg, variables, tmp_path)
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    monkeypatch.setattr(layers, "keep_mask", masks.port_keep_mask)
    got = runner.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0,
                            noise=torch.from_numpy(noise))
    assert not masks.queue  # every mask JAX drew was read, in order
    assert _assert_step_matches(runner, pcfg, got, want, before) > 100


# ------------------------------------------------------------ the port's masks


def test_dropout_masks_on_their_own_terms():
    g = torch.Generator().manual_seed(3)
    x = torch.ones(64, 100, 50, dtype=torch.float64)
    drop, path = layers.Dropout(RATE).train(), layers.DropPath(RATE).train()
    layers.set_dropout_generator((drop, path), g)
    y = drop(x)
    n, keep = x.numel(), 1.0 - RATE
    kept = float((y != 0).double().mean())
    assert abs(kept - keep) <= 6 * np.sqrt(keep * RATE / n)
    assert set(torch.unique(y).tolist()) == {0.0, 1.0 / keep}  # kept entries scaled by 1/keep
    z = path(torch.ones(4000, 7, 3, dtype=torch.float64))
    rows = z.reshape(4000, -1)
    assert bool(((rows == 0).all(1) | (rows == 1.0 / keep).all(1)).all())  # whole rows
    kept = float((rows[:, 0] != 0).double().mean())
    assert abs(kept - keep) <= 6 * np.sqrt(keep * RATE / 4000)
    # no draw in eval mode or at rate 0, and no hidden generator in train mode
    state = g.get_state()
    assert drop.eval()(x) is x and path.eval()(x) is x
    zero = layers.Dropout(0.0).train()
    layers.set_dropout_generator((zero,), g)
    assert zero(x) is x and torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match="generator"):
        layers.Dropout(RATE).train()(x)


def test_shipped_config_train_forward_draws_only_the_jitter(tmp_path):
    """At rates 0 the train forward's one draw from the generator is the
    denoise jitter's: the generator ends where a lone (B, 64, 3) normal
    draw leaves it, and the jitter is that draw."""
    pcfg = cfg_from_yaml_file(TINY)
    model = build_model(pcfg.model, device="cpu").train()
    assert model._stochastic == ()
    g, ref = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    x = torch.from_numpy(np.random.RandomState(2).randn(B, N_IN, 3).astype(np.float32) * 0.3)
    with torch.no_grad():
        out = model(x, generator=g)
        noise = torch.randn((B, 64, 3), generator=ref)
        again = model(x, noise=noise)
    assert torch.equal(g.get_state(), ref.get_state())
    for a, b in zip(out, again):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the resume repair


@pytest.fixture(scope="module")
def k2_run(tmp_path_factory):
    """``AdaPoinTr-tiny-k2.yaml`` in float64: numpy-seeded weights, two
    batches; the JAX package's MultiSteps state after the first batch saved
    as ``ckpt-last.ckpt``, and its update after the second."""
    cfg = jax_cfg(TINY_K2)
    variables = _variables(cfg, 23)
    rng = np.random.RandomState(41)
    batches = [{"partial": rng.randn(B, N_IN, 3) * 0.3, "gt": rng.randn(B, N_GT, 3) * 0.3} for _ in range(2)]
    noises = [rng.randn(B, 64, 3) for _ in range(2)]
    patch = pytest.MonkeyPatch()
    with x64():
        v64 = _f64(variables)
        runner = jax_runner.Runner(types.SimpleNamespace(tp=1), cfg)
        key = jax.random.PRNGKey(0)

        def grads_of(params, batch_stats, batch, noise, bnm):
            patch.setattr(jops, "jitter_points",
                          lambda key, pc, std=0.01, clip=0.05: pc + jnp.clip(std * noise, -clip, clip))

            def loss(params):
                ret, upd = runner.module.apply({"params": params, "batch_stats": batch_stats},
                                               batch["partial"], train=True, bn_momentum=bnm,
                                               rngs={"noise": key, "dropout": key}, mutable=["batch_stats"])
                sparse, dense = runner.spec.loss_fn(ret, batch["gt"], 0.0)
                return sparse + dense, upd["batch_stats"]

            return jax.grad(loss, has_aux=True)(params)

        try:
            tx, _, bnm_sched = jax_build_opt_sched(cfg, STEPS_PER_EPOCH, v64["params"])
            fn, update = jax.jit(grads_of), jax.jit(tx.update)
            state = {"params": v64["params"], "batch_stats": v64["batch_stats"],
                     "opt_state": tx.init(v64["params"]), "step": jnp.zeros((), jnp.int32)}
            for i, (batch, noise) in enumerate(zip(batches, noises)):
                jb = {k: jnp.asarray(v) for k, v in batch.items()}
                grads, new_bs = fn(state["params"], state["batch_stats"], jb, jnp.asarray(noise), bnm_sched(0.0))
                updates, new_opt = update(grads, state["opt_state"], state["params"])
                state = {"params": optax.apply_updates(state["params"], updates), "batch_stats": new_bs,
                         "opt_state": new_opt, "step": state["step"] + 1}
                if i == 0:
                    assert int(state["opt_state"].mini_step) == 1
                    exp = tmp_path_factory.mktemp("jax_k2")
                    jax_checkpoint.save_checkpoint(state, None, None, 0, "ckpt-last", str(exp))
        finally:
            patch.undo()
    return {"variables": variables, "batches": batches, "noises": noises, "exp": exp,
            "after": _np_tree(state), "grads": _np_tree(grads)}


def _k2_runner(variables, tmp_path):
    pcfg = cfg_from_yaml_file(TINY_K2)
    return _port_runner(pcfg, variables, tmp_path), pcfg


def test_resume_mid_accumulation_matches_the_uninterrupted_run(k2_run, tmp_path, one_torch_thread):
    """The port's ``.pth`` saved between the two batches of an update keeps
    their pending sum; the resumed run's update is the uninterrupted one's,
    bit for bit. So is the JAX ``.ckpt``'s: its ``MultiSteps`` running
    mean, times the batches it holds, resumes into JAX's own next update."""
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in k2_run["batches"]]
    noises = [torch.from_numpy(n) for n in k2_run["noises"]]
    straight, pcfg = _k2_runner(k2_run["variables"], tmp_path / "a")
    straight.train_step(batches[0], 0.0, noise=noises[0])
    path = straight.save("ckpt-last", 0, None, None)
    raw = torch.load(path, weights_only=True)
    assert set(raw["pending_grads"]) == {n for n, p in straight.model.named_parameters() if p.grad is not None}
    straight.train_step(batches[1], 0.0, noise=noises[1])

    resumed, _ = _k2_runner(k2_run["variables"], tmp_path / "b")
    resumed.resume(path)
    assert resumed.step == 1
    resumed.train_step(batches[1], 0.0, noise=noises[1])
    for (n, a), (_, b) in zip(straight.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), n

    # from the JAX package's checkpoint: the next update is JAX's
    from_jax, _ = _k2_runner(k2_run["variables"], tmp_path / "c")
    before = {n: p.detach().clone() for n, p in from_jax.model.named_parameters()}
    from_jax.resume(str(k2_run["exp"] / "ckpt-last.ckpt"))
    assert from_jax.step == 1
    pending = {n for n, p in from_jax.model.named_parameters() if p.grad is not None}
    assert pending == {n for n, p in straight.model.named_parameters() if p.grad is not None}
    got = from_jax.train_step(batches[1], 0.0, noise=noises[1])
    jparams = _params_from_flax(k2_run["after"]["params"], pcfg.model)
    jgrads = _params_from_flax(k2_run["grads"], pcfg.model)
    n_live = 0
    for name, p in from_jax.model.named_parameters():
        if _is_zero_grad(name):
            assert p.grad is None and torch.equal(p, before[name]), name
            continue
        diff = np.abs(p.detach().numpy() - jparams[name])
        live = np.abs(jgrads[name]) > GRAD_FLOOR
        assert float(diff[live].max(initial=0.0)) <= 1e-9, name
        n_live += int(live.any())
    assert n_live > 50 and float(got["grad_norm"]) > 0
    # and the port's own resumed update equals the JAX one's
    for name, p in resumed.model.named_parameters():
        if not _is_zero_grad(name):
            live = np.abs(jgrads[name]) > GRAD_FLOOR
            assert float(np.abs(p.detach().numpy() - jparams[name])[live].max(initial=0.0)) <= 1e-9, name


# ------------------------------------------------------------ the three ops


def test_square_distance_gather_points_ball_query_match_jax():
    rng = np.random.RandomState(12)
    src, dst = rng.randn(2, 70, 3), rng.randn(2, 90, 3)
    with x64():
        want = np.asarray(jops.square_distance(jnp.asarray(src), jnp.asarray(dst)))
    got = ops.square_distance(torch.from_numpy(src), torch.from_numpy(dst))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    idx = rng.randint(0, 90, size=(2, 33, 4))
    with x64():
        want = np.asarray(jops.gather_points(jnp.asarray(dst), jnp.asarray(idx)))
    np.testing.assert_array_equal(ops.gather_points(torch.from_numpy(dst), torch.from_numpy(idx)).numpy(), want)
    # ball_query in float64 on seeded clouds (no pair near a radius for the
    # rounding of either form to matter): every in-ball count from 0 to past nsample
    xyz, q = rng.uniform(-1, 1, (3, 400, 3)), rng.uniform(-1.3, 1.3, (3, 120, 3))
    for radius, nsample in ((0.05, 8), (0.2, 16), (0.4, 32), (3.0, 500)):
        with x64():
            want = np.asarray(jops.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(q)))
        got = ops.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(q))
        assert got.dtype == torch.int64 and got.shape == (3, 120, nsample)
        np.testing.assert_array_equal(got.numpy(), want)
    # and in float32 on lattice clouds (coordinates k/64: both forms exact, no distance at r²)
    lat = (rng.randint(-64, 65, (2, 300, 3)) / 64).astype(np.float32)
    want = np.asarray(jops.ball_query(0.3, 24, jnp.asarray(lat), jnp.asarray(lat[:, :90])))
    got = ops.ball_query(0.3, 24, torch.from_numpy(lat), torch.from_numpy(lat[:, :90]))
    np.testing.assert_array_equal(got.numpy(), want)
    empty = ops.ball_query(0.01, 4, torch.from_numpy(xyz), torch.full((1, 2, 3), 5.0).expand(3, 2, 3))
    assert int(empty.abs().sum()) == 0  # no point in the ball: index 0


def test_test_protocol_at_the_fold_heads_sizes_matches_jax():
    """The fold head's fine cloud has twice the ground truth's points
    (32768 against 16384 on the flagship): neither package refuses
    unequal clouds in the test protocol, and its rows, the auction EMD
    included, agree at 2:1 (192 against 96, zero-padded rows in two
    samples). JAX's test step on the CPU bids with its XLA top-2; its
    Pallas top-2 in the interpreter parts from that path itself on sample
    1 here (7 of 192 assignments, after iteration 70 of an auction that
    cannot finish with more bidders than items), so the rows are held to
    the CPU path."""
    from test_torch_test_rows import _assert_rows, _jax_rows

    from imgadapointr_tpu_torch.utils import metrics

    rng = np.random.RandomState(5)
    v = rng.randn(3, 96, 3)
    gt = 0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    pred = np.concatenate([gt, gt], 1)[:, rng.permutation(192)] + 0.006 * rng.randn(3, 192, 3)
    gt[1, -20:] = 0.0  # zero-padded rows, as the test protocol drops them
    pred[2, -30:] = 0.0
    want = _jax_rows(pred, gt, True)
    got = metrics.compute_metrics_per_sample(torch.from_numpy(pred), torch.from_numpy(gt), require_emd=True,
                                             ignore_zeros=True).numpy()
    _assert_rows(got, want)
    assert bool((got[:, 3] > 0).all())
