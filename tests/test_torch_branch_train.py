"""The branch models' training against the JAX package, on the CPU.

Covers the weighted gather-sum's VJP (the port's Function with its plain
backward, against ``jax.vjp`` of the Pallas kernel in interpret mode and of
the XLA chain), SGCAM's commuted product, GDANet's VJP into its input
points, the variable coarse-loss weight, and whole train steps of the
superset ``ImgEncSegDecAdaPoinTrVariableLoss`` (two, the second from the
JAX run's converted AdamW state) and of ImgAdaPoinTr (one), on
``cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml`` with 64x64 images, from
numpy-seeded flax trees carried across by the converter, against the JAX
runner's ``_train_step``. The denoise jitter is fixed on both sides, as in
``tests/test_torch_train.py``, whose tolerances these steps share: both
sides in float64; losses 1e-9 relative, every trainable gradient 1e-8 of
the gradient norm, updated parameters 1e-9 where the gradient is above
1e-9, BN statistics 1e-10 of their largest.

The frozen GDANet: the JAX runner logs the norm of the raw gradients
(``runner.py:253``), which include GDANet's flow-through gradient; its clip
zeroes that subtree first (``builder.py:166-178``). The port's GDANet takes
no gradient at all, and its ``grad_norm`` is the clip's norm: the test
holds it to the JAX norm over the non-frozen leaves, and GDANet's
parameters unchanged on both sides.

The JAX package commutes SGCAM's product only on a TPU; the port does in
train mode on every device. Both forms are checked against JAX here, and
the train steps hold with the JAX side uncommuted: the forms differ by
float64 rounding only.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_seg import (  # noqa: F401  (one_torch_thread: a fixture)
    IMG,
    _gather_sum_case,
    as_f64,
    build_pair,
    model_inputs,
    one_torch_thread,
    random_tree,
    x64,
)

import imgadapointr_tpu.ops as jops
from imgadapointr_tpu.models import gdanet as jax_gdanet
from imgadapointr_tpu.models import seg_adapointr as jax_seg
from imgadapointr_tpu.models.img_adapointr import variable_alpha as jax_variable_alpha
from imgadapointr_tpu.ops import index_points as jax_index_points
from imgadapointr_tpu.ops.pallas.gather_sum import weighted_gather_sum_pallas
from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
from imgadapointr_tpu.tools.runner import Runner as JaxRunner
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.models import gdanet as port_gdanet
from imgadapointr_tpu_torch.models.losses import variable_alpha
from imgadapointr_tpu_torch.models.seg_adapointr import seg_features
from imgadapointr_tpu_torch.tools.convert import (
    _leaf,
    _mapping,
    _params_from_flax,
    adamw_state_from_optax,
    state_dict_from_flax,
)
from imgadapointr_tpu_torch.tools.runner import Runner
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = "cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml"
SUPERSET = "ImgEncSegDecAdaPoinTrVariableLoss"
IMG_MODEL = "ImgResNetEncAdaPoinTrVariableLoss"
B = 2
STEPS_PER_EPOCH = 4
GRAD_FLOOR = 1e-9
ATOL = 1e-9


# ------------------------------------------------- weighted gather-sum VJP


def _port_vjp(w, idx, f, g):
    tw = torch.from_numpy(w).requires_grad_()
    tf = torch.from_numpy(f).requires_grad_()
    ops.weighted_gather_sum(tw, torch.from_numpy(idx), tf).backward(torch.from_numpy(g))
    return tw.grad.numpy(), tf.grad.numpy()


def _pallas_vjp(w, idx, f, g):
    """``jax.vjp`` of the Pallas kernel in interpret mode (float32)."""
    i32 = jnp.asarray(idx, jnp.int32)
    _, vjp = jax.vjp(lambda w_, f_: weighted_gather_sum_pallas(w_, i32, f_, True),
                     jnp.asarray(w, jnp.float32), jnp.asarray(f, jnp.float32))
    return (np.asarray(a) for a in vjp(jnp.asarray(g, jnp.float32)))


def _dyadic_cotangent(seed, B_, S, C):
    return np.random.RandomState(seed).randint(-8, 9, (B_, S, C)).astype(np.float64)


@pytest.mark.parametrize("shape", [(2, 40, 7, 50, 12), (1, 64, 63, 64, 64), (2, 17, 5, 9, 3)])
def test_weighted_gather_sum_vjp_matches_pallas_and_xla(shape):
    """``dw`` and ``dfeats`` against the Pallas VJP on dyadic inputs (every
    product and partial sum exact in its float32) and against the XLA
    chain's VJP in float64, to 1e-9."""
    B_, S, K, M, C = shape
    w, idx, f = _gather_sum_case(1, *shape, dyadic=True)
    g = _dyadic_cotangent(4, B_, S, C)
    dw, df = _port_vjp(w, idx, f, g)
    pdw, pdf = _pallas_vjp(w, idx, f, g)
    np.testing.assert_allclose(dw, pdw, rtol=0, atol=ATOL)
    np.testing.assert_allclose(df, pdf, rtol=0, atol=ATOL)

    w, idx, f = _gather_sum_case(2, *shape)
    g = np.random.RandomState(5).randn(B_, S, C)
    dw, df = _port_vjp(w, idx, f, g)
    with x64():
        _, vjp = jax.vjp(lambda w_, f_: jnp.sum(w_[..., None] * jax_index_points(f_, jnp.asarray(idx)), axis=2),
                         jnp.asarray(w), jnp.asarray(f))
        xdw, xdf = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(dw, xdw, rtol=0, atol=ATOL)
    np.testing.assert_allclose(df, xdf, rtol=0, atol=ATOL)


def test_weighted_gather_sum_vjp_out_of_range_indices():
    """An out-of-range index gets ``dw = 0`` and adds nothing to
    ``dfeats``, as in the Pallas VJP (no column of W); the wrappers
    called directly give the same."""
    w, idx, f = _gather_sum_case(3, 2, 30, 9, 40, 8, dyadic=True)
    idx[:, :, 0] = -1
    idx[:, :4, 1], idx[:, 4:8, 2] = 40, 10**6
    g = _dyadic_cotangent(6, 2, 30, 8)
    dw, df = _port_vjp(w, idx, f, g)
    pdw, pdf = _pallas_vjp(w, idx, f, g)
    np.testing.assert_array_equal(dw, pdw)
    np.testing.assert_array_equal(df, pdf)
    invalid = (idx < 0) | (idx >= 40)
    assert not dw[invalid].any() and dw[~invalid].any()
    want = np.zeros_like(f)
    for b, s, m in zip(*np.nonzero(~invalid)):
        want[b, idx[b, s, m]] += w[b, s, m] * g[b, s]
    np.testing.assert_array_equal(df, want)
    tw, ti, tf, tg = (torch.from_numpy(a) for a in (w, idx, f, g))
    np.testing.assert_array_equal(ops.weighted_gather_sum_dweights(ti, tg, tf).numpy(), dw)
    np.testing.assert_array_equal(ops.weighted_gather_sum_dfeats(tw, ti, tg, 40).numpy(), df)
    with pytest.raises(ValueError):
        ops.weighted_gather_sum_dweights(ti, tg[:, :5], tf)


@pytest.mark.parametrize("shape", [(2, 40, 3, 9, 8), (1, 300, 3, 16, 5), (3, 25, 7, 30, 4)])
def test_dfeats_plain_sums_each_row_in_term_order(shape):
    """The plain ``dfeats`` equals, bit for bit, a float32 loop that adds
    each term's product ``w · g`` (rounded once) into its row in increasing
    flat (s, m) order from zero, skipping out-of-range indices: the order
    the kernel repeats on the card. Few rows, so that each gets many terms;
    some indices repeat within a row's K, some lie out of range."""
    B_, S, K, M, C = shape
    rng = np.random.RandomState(sum(shape))
    w = rng.randn(B_, S, K).astype(np.float32)
    idx = rng.randint(-2, M + 2, (B_, S, K))
    idx[:, ::5, 1] = idx[:, ::5, 0]
    g = rng.randn(B_, S, C).astype(np.float32)
    want = np.zeros((B_, M, C), np.float32)
    for b, s, m in np.ndindex(B_, S, K):
        if 0 <= idx[b, s, m] < M:
            want[b, idx[b, s, m]] = want[b, idx[b, s, m]] + w[b, s, m] * g[b, s]
    assert want.dtype == np.float32
    tw, ti, tg = (torch.from_numpy(a) for a in (w, idx, g))
    np.testing.assert_array_equal(ops.weighted_gather_sum_dfeats_plain(tw, ti, tg, M).numpy(), want)
    np.testing.assert_array_equal(ops.weighted_gather_sum_dfeats(tw, ti, tg, M).numpy(), want)


# ------------------------------------------------------------------ GDANet


def _port_sgcam(v) -> port_gdanet.SGCAM:
    port = port_gdanet.SGCAM(64).double()
    p, s = v["params"], v["batch_stats"]
    with torch.no_grad():
        for n in ("g", "theta", "phi"):
            getattr(port, n).weight.copy_(torch.from_numpy(p[n]["kernel"].T))
            getattr(port, n).bias.copy_(torch.from_numpy(p[n]["bias"]))
        port.W[0].weight.copy_(torch.from_numpy(p["W_conv"]["kernel"].T))
        port.W[0].bias.copy_(torch.from_numpy(p["W_conv"]["bias"]))
        bn = port.W[1]
        bn.weight.copy_(torch.from_numpy(p["W_bn_scale"]))
        bn.bias.copy_(torch.from_numpy(p["W_bn_bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["W_bn_mean"]))
        bn.running_var.copy_(torch.from_numpy(s["W_bn_var"]))
    return port.eval()


def test_sgcam_commute_matches_jax():
    """``commute=True`` against JAX ``SGCAM(...)(x, x2, commute=True)``,
    and equal to the reference order up to rounding."""
    rng = np.random.RandomState(7)
    x, x2 = rng.randn(2, 50, 64), rng.randn(2, 30, 64)
    module = jax_gdanet.SGCAM(64)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((2, 50, 64)),
                                                jnp.zeros((2, 30, 64))))
    v = random_tree(dict(shapes), 8)
    with x64():
        want = np.asarray(module.apply(as_f64(v), jnp.asarray(x), jnp.asarray(x2), commute=True))
    port = _port_sgcam(v)
    tx, tx2 = torch.from_numpy(x), torch.from_numpy(x2)
    with torch.no_grad():
        got = port(tx, tx2, commute=True).numpy()
        plain = port(tx, tx2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-12)
    assert np.abs(want - x).max() > 0.1  # the attention branch is not the identity


@pytest.fixture(scope="module")
def superset():
    return build_pair(SUPERSET, seed=5)


@pytest.mark.parametrize("commute", [False, True], ids=["reference_order", "commuted"])
def test_gdanet_vjp_into_its_points_matches_jax(superset, commute):
    """The frozen GDANet's features and their VJP into the input points,
    normals included (``seg_features``), against ``jax.vjp`` of the JAX
    package's GDANet on the same scrambled normals, to 1e-9; GDANet's own
    parameters take no gradient."""
    _, _, variables, model = superset
    rng = np.random.RandomState(9)
    coor = rng.randn(2, 128, 3) * 0.3
    cot = rng.randn(2, 128, 128)
    cls = model_inputs()["cls_vec"]
    with x64():
        v = as_f64({k: variables[k]["segmentator"] for k in ("params", "batch_stats")})

        def feat_fn(c):
            return jax_gdanet.GDANet(50).apply(v, c, jax_seg._scrambled_normals(c), jnp.asarray(cls),
                                               fast_sgcam=commute)[0]

        jfeat, vjp = jax.vjp(jax.jit(feat_fn), jnp.asarray(coor))
        (jgrad,) = vjp(jnp.asarray(cot))
    gdanet = model.base_model.segmentator
    tc = torch.from_numpy(coor).requires_grad_()
    feat = seg_features(gdanet, tc, torch.from_numpy(cls), commute=commute)
    feat.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgrad), rtol=0, atol=ATOL)
    assert float(np.abs(np.asarray(jgrad)).max()) > 1e-3  # the gradient does flow through
    assert all(p.grad is None and not p.requires_grad for p in gdanet.parameters())


def test_no_train_step_reaches_the_gather_sum_vjp(monkeypatch):
    """The GDM's neighbour sum feeds only a top-k ranking, so no cotangent
    reaches it: the JAX package's jitted gradient through ``gdm`` (the
    Pallas kernel forced on, in interpret mode) never calls its VJP, and
    the port's superset train step calls the forward twice and neither
    backward wrapper."""
    from imgadapointr_tpu.ops.pallas import gather_sum as jax_gather_sum
    from imgadapointr_tpu_torch.ops import gather_sum as port_gather_sum

    calls = {"jax_bwd": 0, "forward": 0, "dfeats": 0, "dweights": 0}

    def spy(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jax_gather_sum, "_bwd_impl", spy(jax_gather_sum._bwd_impl, "jax_bwd"))
    monkeypatch.setattr(jax_gdanet, "_aggregate_neighbours",
                        lambda a, i, x: weighted_gather_sum_pallas(a, i, x, True))
    x = jnp.asarray(np.random.RandomState(0).randn(2, 128, 64).astype(np.float32) * 0.02)

    def loss(x):
        sharp, gentle = jax_gdanet.gdm(x, M=64)
        return jnp.sum(sharp**2) + jnp.sum(gentle)

    assert float(jnp.abs(jax.jit(jax.grad(loss))(x)).max()) > 0
    assert calls["jax_bwd"] == 0

    for name, key in (("weighted_gather_sum_forward", "forward"), ("weighted_gather_sum_dfeats", "dfeats"),
                      ("weighted_gather_sum_dweights", "dweights")):
        monkeypatch.setattr(port_gather_sum, name, spy(getattr(port_gather_sum, name), key))
    cfg = _port_config(SUPERSET)
    runner = Runner(types.SimpleNamespace(device="cpu", seed=0), cfg, logger="silent")
    runner.make_train_state(STEPS_PER_EPOCH)
    batch = dict(model_inputs(3), gt=np.random.RandomState(4).randn(B, 1024, 3) * 0.3)
    out = runner.train_step({k: torch.from_numpy(v).float() for k, v in batch.items()}, 0.0)
    assert np.isfinite(float(out["total_loss"]))
    assert (calls["forward"], calls["dfeats"], calls["dweights"]) == (2, 0, 0)


def test_variable_alpha_matches_jax():
    epochs = np.concatenate([np.arange(41.0), np.linspace(0.0, 40.0, 97), [0.25, 4.99, 5.0, 14.5]])
    with x64():
        want = np.asarray(jax_variable_alpha(jnp.asarray(epochs)))
    got = np.array([variable_alpha(e) for e in epochs])
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    assert got.min() < 0.05 and got.max() > 0.95  # the cycle's whole range


# --------------------------------------------------------------- train steps


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _adam_state(opt_state):
    (found,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return found


class _RecordingTx:
    """The runner's optax transform, keeping the raw gradients that
    ``_train_step`` hands it (tracers of the same jit trace, returned from
    it), so one forward and backward serves both the step and the check."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params=None):
        self.grads.append(grads)
        return self.tx.update(grads, state, params)


def _jax_run(name: str, n_steps: int, seed: int) -> dict:
    """``n_steps`` consecutive JAX train steps of ``name`` on fixed inputs,
    with the raw gradients of each; one jit compile serves them all."""
    cfg, spec, variables, _ = build_pair(name, seed)
    rng = np.random.RandomState(21)
    batches = []
    for i in range(n_steps):
        batch = {k: v for k, v in model_inputs(i).items() if k in spec.inputs}
        batch["gt"] = rng.randn(B, int(cfg.model.num_points), 3) * 0.3
        batches.append(batch)
    noises = [rng.randn(B, 64, 3) for _ in range(n_steps)]
    epochs = [i / STEPS_PER_EPOCH for i in range(n_steps)]
    out = {"name": name, "batches": batches, "noises": noises, "epochs": epochs}
    patch = pytest.MonkeyPatch()
    with x64():
        v64 = as_f64(dict(variables))
        runner = JaxRunner(types.SimpleNamespace(tp=1), cfg)
        tx, runner.lr_sched, runner.bnm_sched = jax_build_opt_sched(
            cfg, STEPS_PER_EPOCH, v64["params"], frozen_paths=tuple(runner.spec.frozen_paths))
        runner.tx = _RecordingTx(tx)
        runner.steps_per_epoch = STEPS_PER_EPOCH
        state = {"params": v64["params"], "batch_stats": v64["batch_stats"],
                 "opt_state": runner.tx.init(v64["params"]), "step": jnp.zeros((), jnp.int32)}
        key = jax.random.PRNGKey(0)

        def step_and_grads(state, batch, noise, epoch_f):
            # the model reads `ops.jitter_points` at trace time: hand it this step's noise
            patch.setattr(jops, "jitter_points",
                          lambda key, pc, std=0.01, clip=0.05: pc + jnp.clip(std * noise, -clip, clip))
            runner.tx.grads.clear()
            return runner._train_step(state, batch, key, epoch_f), runner.tx.grads[-1]

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


@pytest.fixture(scope="module")
def superset_run():
    return _jax_run(SUPERSET, 2, seed=5)


def _port_config(name):
    cfg = cfg_from_yaml_file(TINY)
    cfg.model.NAME, cfg.model.img_size = name, IMG
    return cfg


def _state_dict_f64(params, batch_stats, model_cfg) -> dict:
    """:func:`state_dict_from_flax` with the float64 values kept."""
    sd = state_dict_from_flax(params, batch_stats, model_cfg)
    p64 = _params_from_flax(params, model_cfg)
    for tkey, kind, path, _ in _mapping(model_cfg):
        if kind == "stats":
            sd[tkey] = torch.from_numpy(np.array(_leaf(batch_stats, path), dtype=np.float64))
        elif tkey in p64:
            sd[tkey] = torch.from_numpy(np.array(p64[tkey], dtype=np.float64))
    return sd


def _port_runner(run, state, tmp_path):
    """The port's runner in float64 on the CPU, loaded with a JAX state's
    weights and BN statistics."""
    cfg = _port_config(run["name"])
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path))
    runner = Runner(args, cfg, logger="silent")
    runner.model.double()
    runner.make_train_state(STEPS_PER_EPOCH)
    runner.model.load_state_dict(_state_dict_f64(state["params"], state["batch_stats"], cfg.model),
                                 strict=True)
    return runner, cfg


def _check_step(run, i, runner, cfg):
    """Port step ``i`` against the JAX run's."""
    batch = {k: torch.from_numpy(v) for k, v in run["batches"][i].items()}
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    got = runner.train_step(batch, run["epochs"][i], noise=torch.from_numpy(run["noises"][i]))
    want = run["metrics"][i]
    for k in ("sparse_loss", "dense_loss", "total_loss", "lr"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)

    jgrads = _params_from_flax(run["grads"][i], cfg.model)
    jprev = _params_from_flax(run["states"][i]["params"], cfg.model)
    jparams = _params_from_flax(run["states"][i + 1]["params"], cfg.model)
    frozen = [n for n in jgrads if n.startswith("base_model.segmentator.")]
    # the clip's norm: the non-frozen leaves (JAX logs the raw norm)
    norm = float(np.sqrt(sum(float((g**2).sum()) for n, g in jgrads.items() if n not in frozen)))
    np.testing.assert_allclose(float(got["grad_norm"]), norm, rtol=1e-9)
    if frozen:
        assert want["grad_norm"] > norm * (1 + 1e-6)  # GDANet's flow-through gradient
    else:
        np.testing.assert_allclose(want["grad_norm"], norm, rtol=1e-9)
    coef = min(10.0 / (norm + 1e-6), 1.0)
    lr = want["lr"]
    n_floor = 0
    for name, p in runner.model.named_parameters():
        if name in frozen:
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(p, before[name]), name
            np.testing.assert_array_equal(jparams[name], jprev[name], err_msg=name)
            continue
        if "query_ranking" in name or "encoder.norm" in name:
            assert p.grad is None and torch.equal(p, before[name]), name
            continue
        g, jg = p.grad.numpy(), jgrads[name] * coef
        assert float(np.abs(g - jg).max()) <= 1e-8 * norm, name
        live = np.abs(jg) > GRAD_FLOOR
        n_floor += int((~live).sum())
        diff = np.abs(p.detach().numpy() - jparams[name])
        assert float(diff[live].max(initial=0.0)) <= 1e-9, name
        assert float(diff.max()) <= 2.0 * lr + 1e-9, name
    n_train = sum(p.numel() for p in runner.model.parameters() if p.requires_grad)
    assert n_floor < 0.2 * n_train, f"{n_floor} of {n_train} entries under the gradient floor"

    # BatchNorm statistics: ResNet's and increase_dim's move, GDANet's do not
    sd = runner.model.state_dict()
    new_bs, old_bs = run["states"][i + 1]["batch_stats"], run["states"][i]["batch_stats"]
    moved = 0
    for tkey, kind, path, _ in _mapping(cfg.model):
        if kind != "stats":
            continue
        want_s = np.asarray(_leaf(new_bs, path))
        np.testing.assert_allclose(sd[tkey].numpy(), want_s, rtol=0,
                                   atol=1e-10 * float(np.abs(want_s).max()), err_msg=tkey)
        moved += int(not np.array_equal(want_s, np.asarray(_leaf(old_bs, path))))
        if tkey.startswith("base_model.segmentator."):
            np.testing.assert_array_equal(want_s, np.asarray(_leaf(old_bs, path)), err_msg=tkey)
    assert moved >= 2
    return got


def test_superset_train_step_matches_jax(superset_run, tmp_path):
    runner, cfg = _port_runner(superset_run, superset_run["states"][0], tmp_path)
    got = _check_step(superset_run, 0, runner, cfg)
    assert runner.step == 1 and float(got["total_loss"]) > 0
    # AdamW holds moments for the trainable parameters only: not GDANet's
    names = {id(p): n for n, p in runner.model.named_parameters()}
    grouped = {names[id(p)] for group in runner.optimizer.param_groups for p in group["params"]}
    assert not any("segmentator" in n for n in grouped)
    assert {names[id(p)] for p in runner.optimizer.state} <= grouped


def test_superset_train_step_continues_jax_run_from_converted_optimizer_state(superset_run, tmp_path):
    """Step 2 from the JAX run's state after step 1: weights, BN statistics
    and the AdamW moments and count, GDANet's zero moments left behind."""
    state = superset_run["states"][1]
    runner, cfg = _port_runner(superset_run, state, tmp_path)
    adam = _adam_state(state["opt_state"])
    sd = adamw_state_from_optax(adam.mu, adam.nu, int(adam.count), cfg.model,
                                runner.model, runner.optimizer)
    runner.optimizer.load_state_dict(sd)
    runner.step = int(state["step"])
    assert runner.step == 1
    _check_step(superset_run, 1, runner, cfg)
    adam2 = _adam_state(superset_run["states"][2]["opt_state"])
    mu2 = _params_from_flax(adam2.mu, cfg.model)
    nu2 = _params_from_flax(adam2.nu, cfg.model)
    norm = superset_run["metrics"][1]["grad_norm"]
    for name, p in runner.model.named_parameters():
        if p in runner.optimizer.state:
            st = runner.optimizer.state[p]
            assert float(st["step"]) == 2.0
            np.testing.assert_allclose(st["exp_avg"].numpy(), mu2[name], rtol=0, atol=1e-9 * norm,
                                       err_msg=name)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu2[name], rtol=0,
                                       atol=1e-9 * norm**2, err_msg=name)
        elif name.startswith("base_model.segmentator."):
            assert not np.any(mu2[name]) and not np.any(nu2[name])


def test_img_adapointr_train_step_matches_jax(tmp_path):
    run = _jax_run(IMG_MODEL, 1, seed=11)
    runner, cfg = _port_runner(run, run["states"][0], tmp_path)
    _check_step(run, 0, runner, cfg)
