"""The ShapeNet-55 and KITTI recipes and the on-disk entry point, on the CPU.

``cfgs/PCN_models/AdaPoinTr-tiny.yaml`` cut further (``SMALL``: 32 queries,
256 points out, one graph block a stack) with the dataset blocks of
``cfgs/ShapeNet55_models/AdaPoinTr.yaml`` (the train crop) and of
``cfgs/KITTI_models/AdaPoinTr.yaml`` (the train dropping), the JAX package's
canonical init carried across by the converter, in float64 on both sides
(as ``tests/test_torch_train.py``):

- one train step of each recipe against the JAX runner's, on the same
  weights, the same augmentation draws (JAX's key split as the JAX runner
  splits it, handed to the port) and the same denoise noise: losses within
  1e-5 and the gradient norm within 1e-4, relative;
- the ShapeNet-55 protocol in ``easy``, ``median`` and ``hard`` at
  ``val_bs`` 1 and 2: the per-taxonomy table and its mean within 1e-5,
  relative, of JAX's rows, composed from the parts JAX's
  ``_test_shapenet55`` composes (one compile serves every mode), and those
  rows within 1e-9 of JAX's ``_test_shapenet55`` itself in one mode. A CPU
  pass costs about a second a crop, so these runs take two of the 8
  viewpoints (patched alike into both packages; the constants are held
  equal, and ``chip_smoke.py`` and the entry-point test run all 8);
- the KITTI protocol writes one 800 x 400 image a cloud;
- ``python -m imgadapointr_tpu_torch.main --device cpu`` trains, validates
  and tests (``--val_bs 2``) from a written PCN tree, and trains and tests
  (``--mode hard``) from a written ShapeNet-55 tree.

The clouds that reach FPS lie on a lattice (coordinates k/64), so that
JAX's float32 matmul-form FPS and the port's float64 diff form rank alike
(``tests/test_torch_data.py``).
"""

import contextlib
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

import imgadapointr_tpu.ops as jops
from imgadapointr_tpu.tools import runner as jax_runner
from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import main as port_main
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.tools.convert import _params_from_flax, state_dict_from_flax
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from imgadapointr_tpu_torch.utils.io_module import IO
from parity.param_source import init_variables

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = "cfgs/PCN_models/AdaPoinTr-tiny.yaml"
RECIPES = {"crop": "cfgs/ShapeNet55_models/AdaPoinTr.yaml", "dropping": "cfgs/KITTI_models/AdaPoinTr.yaml"}
B, N_SHAPENET = 2, 8192
LOSS_RTOL, GRAD_NORM_RTOL, TABLE_RTOL = 1e-5, 1e-4, 1e-5


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


SMALL = {
    "NAME": "AdaPoinTr", "num_query": 32, "num_points": 256, "center_num": [64, 32],
    "global_feature_dim": 64, "encoder_type": "graph", "decoder_type": "fc",
    "encoder_config": {"embed_dim": 48, "depth": 1, "num_heads": 6, "k": 4, "n_group": 2, "mlp_ratio": 2.0,
                       "block_style_list": ["attn-graph"], "combine_style": "concat"},
    "decoder_config": {"embed_dim": 48, "depth": 1, "num_heads": 6, "k": 4, "n_group": 2, "mlp_ratio": 2.0,
                       "self_attn_block_style_list": ["attn-graph"], "self_attn_combine_style": "concat",
                       "cross_attn_block_style_list": ["attn-graph"], "cross_attn_combine_style": "concat"},
}


def recipe_config(load, aug=None):
    """The tiny config with the ``SMALL`` model and a recipe's dataset
    blocks (the tiny config's PCN blocks without ``aug``), by ``load``."""
    cfg = load(TINY)
    cfg["model"] = SMALL
    if aug is not None:
        cfg["dataset"] = load(RECIPES[aug])["dataset"]
    return cfg


def lattice(rng, *shape):
    return rng.integers(-32, 33, shape).astype(np.float64) / 64.0


@pytest.fixture(scope="module")
def variables():
    """The JAX init of the ``SMALL`` model, in float64."""
    cfg = recipe_config(jax_cfg)
    with x64():
        v = jax.jit(lambda: init_variables(cfg.model, "adapointr", batch=B, n_points=256)[1])()
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), dict(jax.device_get(v)))


def port_runner_with(variables, cfg, tmp_path, steps_per_epoch=4, dtype=np.float64):
    """The port's runner on the CPU in ``dtype`` with the JAX init's
    weights and BN statistics."""
    args = types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path))
    runner = port_runner.Runner(args, cfg, logger="silent")
    runner.model.to(torch.from_numpy(np.zeros(0, dtype)).dtype)
    runner.make_train_state(steps_per_epoch)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], cfg.model)
    p64 = _params_from_flax(variables["params"], cfg.model)
    for k in sd:
        if k in p64:
            sd[k] = torch.from_numpy(np.array(p64[k], dtype=dtype))
    bn = variables["batch_stats"]["increase_dim_bn"]
    sd["increase_dim.1.running_mean"] = torch.from_numpy(np.array(bn["mean"], dtype=dtype))
    sd["increase_dim.1.running_var"] = torch.from_numpy(np.array(bn["var"], dtype=dtype))
    runner.model.load_state_dict(sd, strict=True)
    return runner


# ---------------------------------------------------------------- train steps


def _jax_step(variables, cfg, batch, noise, key, epoch_f):
    """One JAX runner train step (its own augmentation inside), with the
    denoise jitter handed ``noise``; its metrics as floats."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jops, "jitter_points",
                  lambda k, pc, std=0.01, clip=0.05: pc + jnp.clip(std * jnp.asarray(noise), -clip, clip))
    try:
        with x64():
            runner = jax_runner.Runner(types.SimpleNamespace(tp=1), cfg)
            params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
            runner.tx, runner.lr_sched, runner.bnm_sched = jax_build_opt_sched(cfg, 4, params)
            state = {"params": params, "batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                     "opt_state": runner.tx.init(params), "step": jnp.zeros((), jnp.int32)}
            _, metrics = jax.jit(runner._train_step)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                                     key, jnp.asarray(epoch_f))
            return runner.train_aug, {k: float(v) for k, v in metrics.items()}
    finally:
        patch.undo()


def _aug_draws(aug, key, epoch_f):
    """The draws JAX's ``Runner._train_step`` makes for the augmentation
    from its step key: ``split(key, 3)[2]``, then the crop's split."""
    with x64():
        rng_aug = jax.random.split(key, 3)[2]
        if aug == "crop":
            k_center, k_crop = jax.random.split(rng_aug)
            center = jax.random.normal(k_center, (B, 1, 3))
            num_crop = jax.random.randint(k_crop, (B, 1), N_SHAPENET // 4, 3 * N_SHAPENET // 4 + 1)
            return {"center": torch.tensor(np.array(center)), "num_crop": torch.tensor(np.array(num_crop))}
        e = int(np.floor(epoch_f))
        keep_n = jax.random.randint(rng_aug, (), 1, max(max(64, 768 // (e // 50 + 1)), 2))
        return {"keep_n": torch.tensor(int(keep_n))}


@pytest.mark.parametrize("aug", ["crop", "dropping"])
def test_recipe_train_step_matches_jax(variables, tmp_path, aug):
    """The ShapeNet-55 step (8192-point gt cropped and FPS'd to 2048 as the
    input) and the KITTI-finetune step (the 2048-point partial thinned at
    epoch 50) against the JAX runner's."""
    rng = np.random.default_rng(31 if aug == "crop" else 32)
    if aug == "crop":
        gt = lattice(rng, B, N_SHAPENET, 3)
        batch = {"partial": gt, "gt": gt}
        epoch_f = 0.25
    else:
        batch = {"partial": lattice(rng, B, 2048, 3), "gt": rng.standard_normal((B, 1024, 3)) * 0.3}
        epoch_f = 50.25
    noise = rng.standard_normal((B, 64, 3))
    key = jax.random.PRNGKey(5)
    jax_aug, want = _jax_step(variables, recipe_config(jax_cfg, aug), batch, noise, key, epoch_f)
    assert jax_aug == aug

    runner = port_runner_with(variables, recipe_config(cfg_from_yaml_file, aug), tmp_path)
    assert (runner.train_aug, runner.train_npoints) == (aug, N_SHAPENET if aug == "crop" else 16384)
    draws = _aug_draws(aug, key, epoch_f)
    got = runner.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, epoch_f,
                            noise=torch.from_numpy(noise), aug=draws)
    for k in ("sparse_loss", "dense_loss", "total_loss"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"], rtol=GRAD_NORM_RTOL)
    if aug == "dropping":  # the epoch's draw: fewer than 384 points kept
        assert 1 <= int(draws["keep_n"]) < 384


def test_select_train_aug_follows_jax():
    """The explicit key, a bare key (``none``), the inference from the
    reader's NAME and CARS, a nested ``_base_``, and a refusal, as the JAX
    runner selects (``imgadapointr_tpu/tools/runner.py:111-140``)."""
    cases = [({"train_aug": "crop", "NAME": "PCN"}, ("crop", 8192)),
             ({"train_aug": None, "NAME": "ShapeNet"}, ("none", 8192)),
             ({"NAME": "ShapeNet", "N_POINTS": 1024}, ("crop", 1024)),
             ({"NAME": "PCN", "CARS": True, "N_POINTS": 16384}, ("dropping", 16384)),
             ({"NAME": "PCN"}, ("none", 8192)), ({"NAME": "ShapeNetPCN"}, ("none", 8192)),
             ({"_base_": {"NAME": "ShapeNet", "N_POINTS": 4096}}, ("crop", 4096))]
    for train, want in cases:
        assert port_runner.select_train_aug({"dataset": {"train": train}}) == want, train
    assert port_runner.select_train_aug({"model": {}}) == ("none", 0)
    with pytest.raises(ValueError, match="crop\\|dropping\\|none"):
        port_runner.select_train_aug({"dataset": {"train": {"train_aug": "flip"}}})


# ------------------------------------------------------------------ protocols


class _Recorder:
    """Wraps a runner module's ``AverageMeter`` to keep every meter made, so
    a test reads the protocol's per-taxonomy table."""

    def __init__(self, module, monkeypatch):
        self.meters = []
        base = module.AverageMeter
        rec = self

        class Meter(base):
            def __init__(self, items=None):
                super().__init__(items)
                rec.meters.append(self)

        monkeypatch.setattr(module, "AverageMeter", Meter)

    def table(self):
        """(count, [F-Score, CDL1, CDL2, EMD]) of each taxonomy's meter, in order of creation."""
        return [(m.count(0), m.avg()) for m in self.meters
                if m.items == ["F-Score", "CDL1", "CDL2", "EMDistance"] and m.count(0)]


TAXES = ["02691156", "03001627"]
VIEWS = [(1, 1, 1), (-1, -1, -1)]  # two of the 8 viewpoints (see the module's docstring)


@pytest.fixture(scope="module")
def shapenet_gts():
    """Two lattice clouds of 8192 points, one of each of two taxonomies."""
    return lattice(np.random.default_rng(40), 2, N_SHAPENET, 3)


def _batches(gts, bs, tensors=False):
    wrap = torch.from_numpy if tensors else (lambda a: a)
    return [(TAXES[i:i + bs], [f"m{j}" for j in range(i, i + bs)],
             {"partial": wrap(gts[i:i + bs]), "gt": wrap(gts[i:i + bs])}) for i in range(0, len(gts), bs)]


@pytest.fixture(scope="module")
def jax_protocol(variables, shapenet_gts):
    """JAX's ShapeNet-55 rows for each mode, composed as its
    ``_test_shapenet55`` composes them (each viewpoint's
    ``separate_point_cloud`` with the point used raw, ``fps`` to 2048,
    ``Runner._eval_step_per_sample`` on the crops against the whole gt,
    viewpoint-major); the three modes' crops in one forward. Returns the
    JAX runner, its state and {mode: (V, B, 5) rows}."""
    cfg = recipe_config(jax_cfg, "crop")
    views = jnp.asarray(VIEWS, jnp.float32)
    with x64():
        jrun = jax_runner.Runner(types.SimpleNamespace(tp=1), cfg)
        state = {k: jax.tree_util.tree_map(jnp.asarray, variables[k]) for k in ("params", "batch_stats")}
        gt = jnp.asarray(shapenet_gts)
        partials = []
        for mode in jax_runner.CROP_RATIO:
            num_crop = int(N_SHAPENET * jax_runner.CROP_RATIO[mode])
            crop = jax.jit(jax.vmap(lambda vp, n=num_crop: jops.fps(
                jops.separate_point_cloud(gt, n, fixed_point=vp)[0], 2048)))
            partials.append(crop(views).reshape(-1, 2048, 3))
        n = partials[0].shape[0]
        gt_rep = jnp.broadcast_to(gt[None], (len(VIEWS),) + gt.shape).reshape(n, N_SHAPENET, 3)
        rows = jax.jit(jrun._eval_step_per_sample)(
            state["params"], state["batch_stats"],
            {"partial": jnp.concatenate(partials), "gt": jnp.concatenate([gt_rep] * len(partials))})
        rows = np.asarray(rows).reshape(len(partials), len(VIEWS), len(gt), -1)
    return jrun, state, dict(zip(jax_runner.CROP_RATIO, rows))


def _table(rows):
    """Each taxonomy's mean [F, CDL1, CDL2, 0] over its cloud's rows (V, B, 5), and their mean."""
    table = np.stack([np.concatenate([rows[:, b][:, [4, 2, 3]].mean(0), [0.0]]) for b in range(rows.shape[1])])
    return table, table.mean(0)


def test_shapenet55_constants_match_jax():
    assert port_runner.SHAPENET55_VIEWPOINTS == jax_runner.SHAPENET55_VIEWPOINTS
    assert port_runner.CROP_RATIO == jax_runner.CROP_RATIO
    assert port_runner.CROP_INPUT_POINTS == 2048


def test_shapenet55_composed_rows_are_jax_protocol(jax_protocol, shapenet_gts, tmp_path, monkeypatch):
    """The composed reference against JAX's ``test`` (``_test_shapenet55``)
    itself, ``hard`` at ``val_bs`` 2: the same table within 1e-9."""
    jrun, state, rows = jax_protocol
    monkeypatch.setattr(jax_runner, "SHAPENET55_VIEWPOINTS", VIEWS)
    rec = _Recorder(jax_runner, monkeypatch)
    args = types.SimpleNamespace(mode="hard", emd=False, tp=1, experiment_path=str(tmp_path))
    with x64():
        overall = jax_runner.test(jrun, state, _batches(shapenet_gts, 2), args, recipe_config(jax_cfg, "crop"),
                                  "silent")
    table, mean = _table(rows["hard"])
    assert [c for c, _ in rec.table()] == [len(VIEWS)] * 2
    np.testing.assert_allclose([r for _, r in rec.table()], table, rtol=1e-9)
    np.testing.assert_allclose([overall[k] for k in port_runner.METRIC_NAMES], mean, rtol=1e-9)


@pytest.mark.parametrize("mode", ["easy", "median", "hard"])
def test_shapenet55_protocol_matches_jax(jax_protocol, variables, shapenet_gts, tmp_path, monkeypatch, mode):
    """The crops (1/4, 1/2, 3/4 of 8192 points dropped, FPS to 2048, all
    crops of a batch in one forward) at ``val_bs`` 1 and 2: the
    per-taxonomy rows and their mean, JAX's within 1e-5; the two batch
    sizes agree to 1e-10."""
    monkeypatch.setattr(port_runner, "SHAPENET55_VIEWPOINTS", VIEWS)
    cfg = recipe_config(cfg_from_yaml_file, "crop")
    port = port_runner_with(variables, cfg, tmp_path)
    want_table, want_mean = _table(jax_protocol[2][mode])
    args = types.SimpleNamespace(mode=mode, emd=False)
    tables = []
    for bs in (1, 2):
        rec = _Recorder(port_runner, monkeypatch)
        overall = port_runner.test(port, _batches(shapenet_gts, bs, tensors=True), args, cfg, "silent")
        assert [c for c, _ in rec.table()] == [len(VIEWS)] * 2
        tables.append(np.array([r for _, r in rec.table()]))
        np.testing.assert_allclose(tables[-1], want_table, rtol=TABLE_RTOL)
        np.testing.assert_allclose([overall[k] for k in port_runner.METRIC_NAMES], want_mean, rtol=TABLE_RTOL)
    np.testing.assert_allclose(tables[1], tables[0], rtol=1e-10)


def test_kitti_protocol_writes_one_image_a_cloud(variables, tmp_path):
    """The KITTI reader on a written tree at batch 1, through ``test``:
    ``<model_id>_<index>.jpg`` for each cloud, an 800 x 400 JPEG, and no
    metric."""
    rng = np.random.default_rng(41)
    (tmp_path / "cars").mkdir()
    (tmp_path / "bboxes").mkdir()
    names = ["frame_0_car_0", "frame_2_car_1"]
    for s in names:
        IO.put(str(tmp_path / "cars" / f"{s}.pcd"), (rng.standard_normal((300, 3)) * 0.5).astype(np.float32))
        box = np.array([[x, y, z] for z in (-0.7, 0.7) for x, y in ((-2, -1), (-2, 1), (2, 1), (2, -1))], np.float32)
        IO.put(str(tmp_path / "bboxes" / f"{s}.txt"), box)
    (tmp_path / "KITTI.json").write_text(json.dumps(names))
    cfg = recipe_config(cfg_from_yaml_file, "dropping")
    cfg.dataset.test.update(CATEGORY_FILE_PATH=str(tmp_path / "KITTI.json"), N_POINTS=2048,
                            CLOUD_PATH=str(tmp_path / "cars/%s.pcd"), BBOX_PATH=str(tmp_path / "bboxes/%s.txt"))
    cfg.dataset.test.others.bs = 1
    runner = port_runner_with(variables, cfg, tmp_path, dtype=np.float32)
    args = types.SimpleNamespace(seed=0, num_workers=0, experiment_path=str(tmp_path / "exp"))
    _, loader = port_runner.dataset_builder(args, cfg.dataset.test)
    assert port_runner.test(runner, loader, args, cfg, "silent") == {}
    images = sorted((tmp_path / "exp" / "vis_result").iterdir())
    assert [p.name for p in images] == [f"{names[0]}_000.jpg", f"{names[1]}_001.jpg"]
    for p in images:  # JAX's figsize (8, 4) at dpi 100
        with Image.open(p) as im:
            assert (im.format, im.size) == ("JPEG", (800, 400))


# ---------------------------------------------------------------- entry point


def _plain(v):
    """An AttrDict as plain dicts and lists, for ``yaml.safe_dump``."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A working directory holding ``cfgs/`` (the repo's) and ``data/``
    trees in the layouts of ``cfgs/dataset_configs/PCN.yaml`` and
    ``ShapeNet55.yaml``, and the tiny model's configs for both recipes."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    (tmp_path / "cfgs").symlink_to(repo / "cfgs")
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(42)
    pcn = tmp_path / "data" / "PCN"
    cats = [{"taxonomy_id": t, "taxonomy_name": t, "train": [f"m{t[-2:]}{i}" for i in range(4)],
             "val": [f"v{t[-2:]}"], "test": [f"t{t[-2:]}"]} for t in ("02691156", "03001627")]
    pcn.mkdir(parents=True)
    (pcn / "PCN.json").write_text(json.dumps(cats))
    for dc in cats:
        for subset in ("train", "val", "test"):
            for m in dc[subset]:
                for r in range(8 if subset == "train" else 1):
                    path = pcn / subset / "partial" / dc["taxonomy_id"] / m / f"{r:02d}.pcd"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    IO.put(str(path), (rng.standard_normal((int(rng.integers(200, 400)), 3)) * 0.3).astype(np.float32))
                path = pcn / subset / "complete" / dc["taxonomy_id"] / f"{m}.pcd"
                path.parent.mkdir(parents=True, exist_ok=True)
                IO.put(str(path), (rng.standard_normal((1024, 3)) * 0.3).astype(np.float32))
    sn = tmp_path / "data" / "ShapeNet55-34"
    (sn / "shapenet_pc").mkdir(parents=True)
    (sn / "ShapeNet-55").mkdir()
    for subset, n in (("train", 8), ("test", 1)):
        lines = [f"{('02691156', '03001627')[i % 2]}-{subset}{i}.npy" for i in range(n)]
        for line in lines:
            IO.put(str(sn / "shapenet_pc" / line), lattice(rng, N_SHAPENET, 3).astype(np.float32))
        (sn / "ShapeNet-55" / f"{subset}.txt").write_text("\n".join(lines) + "\n")
    local = tmp_path / "local"
    local.mkdir()
    for name, aug in (("small-pcn", None), ("small-shapenet", "crop")):
        cfg = recipe_config(cfg_from_yaml_file, aug)
        cfg["max_epoch"] = 1
        (local / f"{name}.yaml").write_text(yaml.safe_dump(_plain(cfg)))
    return tmp_path


def _main(config, *extra):
    return port_main.main(["--config", f"local/{config}.yaml", "--exp_name", "run", "--device", "cpu",
                           "--num_workers", "0", *extra])


def test_main_trains_validates_and_tests_from_disk(run_dir, capfd):
    """One epoch of the PCN recipe from its tree (8 models, one batch of 8),
    validation at ``--val_bs 2``, then ``--test`` from ``ckpt-best`` at
    ``--val_bs 2`` with EMD; one epoch of the ShapeNet-55 recipe (the crop
    on 8192-point clouds; validation on the one test cloud), then its
    8-viewpoint test in ``hard``."""
    runner = _main("small-pcn", "--val_bs", "2")
    exp = run_dir / "experiments" / "small-pcn" / "local" / "run"
    for name in ("ckpt-last.pth", "ckpt-best.pth", "ckpt-epoch-000.pth"):
        assert (exp / name).exists(), name
    assert runner.step == 1 and runner.train_aug == "none"
    log = capfd.readouterr().err
    assert "[Validation] EPOCH: 0" in log and "02691156" in log and "03001627" in log
    scores = _main("small-pcn", "--test", "--ckpts", str(exp / "ckpt-best.pth"), "--val_bs", "2")
    assert "TEST RESULTS" in capfd.readouterr().err
    assert scores["EMDistance"] > 0 and all(np.isfinite(v) for v in scores.values())

    runner = _main("small-shapenet")
    assert runner.step == 1 and runner.train_aug == "crop" and runner.train_npoints == N_SHAPENET
    exp = run_dir / "experiments" / "small-shapenet" / "local" / "run"
    scores = _main("small-shapenet", "--test", "--ckpts", str(exp / "ckpt-last.pth"), "--mode", "hard")
    assert "[ShapeNet-55 hard] Overall" in capfd.readouterr().err
    assert scores["EMDistance"] == 0.0 and scores["CDL1"] > 0 and np.isfinite(scores["CDL2"])


def test_save_freq_keeps_checkpoints_on_save_epochs(run_dir, capfd):
    """``--save_freq 2`` over 4 epochs (validated on epoch 0 only): ckpt-last
    on epochs 0 and 2 and on the last two (2, 3); ckpt-best only on a save
    epoch; ckpt-epoch on the last."""
    cfg = yaml.safe_load((run_dir / "local" / "small-pcn.yaml").read_text())
    cfg["max_epoch"] = 4
    (run_dir / "local" / "small-pcn4.yaml").write_text(yaml.safe_dump(cfg))
    saved = []
    original = port_runner.Runner.save

    def record(self, prefix, epoch, metrics, best):
        saved.append((prefix, epoch))
        return original(self, prefix, epoch, metrics, best)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_runner.Runner, "save", record)
        _main("small-pcn4", "--save_freq", "2", "--val_freq", "4")
    capfd.readouterr()
    last = [e for p, e in saved if p == "ckpt-last"]
    assert last == [0, 2, 3]
    assert [e for p, e in saved if p == "ckpt-best"] == [0]
    assert [e for p, e in saved if p.startswith("ckpt-epoch")] == [3]


def test_save_freq_writes_every_new_best(run_dir, capfd):
    """``--save_freq 2`` over 4 epochs, validated every epoch, with the best
    on epoch 1 (not a save epoch): ``ckpt-best`` is written on every
    improvement, so it holds epoch 1's weights (the JAX runner writes it on
    save epochs only and would lose them). CD-L1 readings 5, 3, 4, 6."""
    from imgadapointr_tpu_torch.utils.metrics import METRIC_NAMES, Metrics

    cfg = yaml.safe_load((run_dir / "local" / "small-pcn.yaml").read_text())
    cfg["max_epoch"] = 4
    (run_dir / "local" / "small-pcn4b.yaml").write_text(yaml.safe_dump(cfg))
    readings = iter([5.0, 3.0, 4.0, 6.0])
    weights = {}

    def validate(runner, val_loader, epoch, logger=None, val_writer=None):
        weights[epoch] = {k: v.clone() for k, v in runner.model.state_dict().items()}
        cd = next(readings)
        return Metrics("CDL1", [0.5 if n == "F-Score" else cd for n in METRIC_NAMES])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_runner, "validate", validate)
        _main("small-pcn4b", "--save_freq", "2")
    capfd.readouterr()
    exp = run_dir / "experiments" / "small-pcn4b" / "local" / "run"
    best = torch.load(exp / "ckpt-best.pth", map_location="cpu", weights_only=False)
    assert best["epoch"] == 1 and best["metrics"]["CDL1"] == 3.0
    for k, v in best["base_model"].items():
        assert torch.equal(v, weights[1][k]), k
    assert not all(torch.equal(v, weights[2][k]) for k, v in best["base_model"].items())
    last = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=False)
    assert last["epoch"] == 3 and last["best_metrics"]["CDL1"] == 3.0
