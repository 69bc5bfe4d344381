"""The port's entry points and runner flags, on the CPU.

- The serving CLI (``tools/inference.py``) from one JAX ``.ckpt`` of
  ``AdaPoinTr-tiny.yaml`` (numpy-seeded float32 weights, saved by the JAX
  package's ``save_checkpoint``) over a ``--pc_root`` of ``.pcd``, ``.ply``
  and ``.txt`` copies of one 700-point cloud (and a file both CLIs skip):
  the three ``fine.npy`` are bit-equal, ``--save_vis_img`` writes
  ``input.jpg`` and ``fine.jpg``, and the JAX CLI
  (``imgadapointr_tpu.tools.inference.main``) gives the same clouds within
  ``SERVE_ATOL``.
- ``PCReconstructor`` (``demo/pcreconstructor.py``) against the JAX
  package's ``demo/pcreconstructor.PCReconstructor`` on
  ``ImgEncSegDec-tiny.yaml`` from one ``.ckpt``, with a ``.png``, a class id
  and a 700-point ``.pcd`` (the tile-up path): the preprocessed inputs are
  bit-equal and the dense clouds agree within ``SERVE_ATOL``.
- The flags: ``--deterministic`` prints JAX's notice and ``--sync_bn`` its
  own, ``--tp 2`` and ``--sp 2`` need a launch whose world they divide,
  the RSS watchdog reads the current RSS, ``--worker_mode thread`` and ``process`` give the
  batches of 0 workers over two epochs, ``--profile`` writes a trace and
  logs the port's spans, each epoch's line counts the loader's work, the
  writers' event files hold JAX's tags, ``--wandb`` without wandb says so
  and goes on, the RSS watchdog exits 75 after ``ckpt-last`` and
  ``--resume`` ends in the state of the uninterrupted run, bit for bit, and
  ``--test`` without ``--ckpts`` warns, then refuses, as the JAX parser and
  ``test_net`` do.

``SERVE_ATOL``: both sides serve in float32, where the repo holds no
float32 serving tolerance against JAX (``tests/test_torch_adapointr.py`` and
``tests/test_torch_seg.py`` compare in float64 to 1e-9). The JAX package's
CPU path ranks kNN and FPS in matmul form and the port in diff form
(``tests/test_torch_adapointr.py``), so the float32 sums differ in their
last bits while every selection is the same: 1e-4 absolute on clouds of
coordinates of order 0.1-1 is about a hundred float32 ulps, far below any
changed selection's effect (a point of another neighbourhood moves a
coordinate by 1e-2 or more).

The runs of ``main`` take synthetic partials of ``N_PARTIAL_SMALL`` points
(the plain kNN's stable sort of 2048² distances a cloud would make each CPU
step seconds), train batches of ``BS_SMALL`` and ``N_EVAL_SMALL``
validation and test clouds (``small_synthetic``).
"""

import json
import os
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgadapointr_tpu.models.build import build_model_spec
from imgadapointr_tpu.tools import inference as jax_inference
from imgadapointr_tpu.utils import checkpoint as jax_checkpoint
from imgadapointr_tpu.utils import parser as jax_parser
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import main as port_main
from imgadapointr_tpu_torch.datasets import DATASETS, native_io
from imgadapointr_tpu_torch.datasets.loader import Loader
from imgadapointr_tpu_torch.demo import PCReconstructor
from imgadapointr_tpu_torch.tools import inference
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.utils import parser as port_parser
from imgadapointr_tpu_torch.utils.io_module import IO
from imgadapointr_tpu_torch.utils.metrics import METRIC_NAMES
from test_torch_data import pcn_config, pcn_root  # noqa: F401  (a fixture)
from test_torch_seg import one_torch_thread, random_tree  # noqa: F401  (a fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = "cfgs/PCN_models/AdaPoinTr-tiny.yaml"
SEG_TINY = "cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml"
SERVE_ATOL = 1e-4
N_PARTIAL_SMALL = 256
BS_SMALL = 2
N_EVAL_SMALL = 4


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A working directory of its own that holds ``cfgs/`` (the configs'
    ``_base_`` includes and ``experiments/`` are relative to it)."""
    (tmp_path / "cfgs").symlink_to(REPO / "cfgs")
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def small_synthetic(monkeypatch):
    """``--synthetic`` partials of ``N_PARTIAL_SMALL`` points, train batches
    of ``BS_SMALL`` and ``N_EVAL_SMALL`` validation and test clouds."""
    swap = port_main.swap_synthetic

    def small(config, train_len=None):
        swap(config, train_len)
        config.total_bs = BS_SMALL
        for name, split in config.dataset.items():
            split["N_PARTIAL"] = N_PARTIAL_SMALL
            if name != "train":
                split["LENGTH"] = N_EVAL_SMALL

    monkeypatch.setattr(port_main, "swap_synthetic", small)


def jax_weights(config_path: str, exp: pathlib.Path, seed: int) -> None:
    """``exp/ckpt-best.ckpt``: numpy-seeded float32 weights of the model's
    init shapes (``jax.eval_shape``: no values computed), saved by the JAX
    package's ``save_checkpoint``."""
    cfg = jax_cfg(config_path)
    spec = build_model_spec(cfg.model)
    example = {"partial": jnp.zeros((1, 2048, 3)), "img": jnp.zeros((1, 224, 224, 3)), "cls_vec": jnp.zeros((1, 16))}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda *i: spec.module.init({"params": key, "noise": key}, *i, train=False),
                            *[example[k] for k in spec.inputs])
    variables = random_tree(dict(shapes), seed)
    state = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    jax_checkpoint.save_checkpoint(state, None, None, 0, "ckpt-best", str(exp))


def a_cloud(n: int = 700, seed: int = 0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n, 3) * 0.3).astype(np.float32)


# ------------------------------------------------------------- the CLI


def test_cli_serves_a_jax_checkpoint_in_every_format(tmp_path, one_torch_thread, monkeypatch):
    jax_weights(TINY, tmp_path / "exp", seed=7)
    ckpt = str(tmp_path / "exp" / "ckpt-best.ckpt")
    root = tmp_path / "clouds"
    root.mkdir()
    cloud = a_cloud()
    for ext in ("pcd", "ply", "txt"):
        IO.put(str(root / f"cloud_{ext}.{ext}"), cloud)
    (root / "notes.json").write_text("{}")  # neither CLI reads it
    inference.main(["--model_config", TINY, "--model_checkpoint", ckpt, "--pc_root", str(root),
                    "--out_pc_root", str(tmp_path / "port"), "--device", "cpu", "--save_vis_img"])
    jax_inference.main(["--model_config", TINY, "--model_checkpoint", ckpt, "--pc_root", str(root),
                        "--out_pc_root", str(tmp_path / "jax")])
    got = {ext: np.load(tmp_path / "port" / f"cloud_{ext}" / "fine.npy") for ext in ("pcd", "ply", "txt")}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f"cloud_{ext}" for ext in got)
    assert got["pcd"].shape == (1024, 3) and np.isfinite(got["pcd"]).all()
    for ext in ("ply", "txt"):
        np.testing.assert_array_equal(got[ext], got["pcd"], err_msg=ext)
    for ext, fine in got.items():
        want = np.load(tmp_path / "jax" / f"cloud_{ext}" / "fine.npy")
        np.testing.assert_allclose(fine, want, rtol=0, atol=SERVE_ATOL, err_msg=ext)
        for name in ("input.jpg", "fine.jpg"):
            assert (tmp_path / "port" / f"cloud_{ext}" / name).stat().st_size > 0
    # one cloud by --pc, a .pth of the same weights, through the native reader (the default): the same answer
    model = inference.build(inference.get_args(["--model_config", TINY, "--model_checkpoint", ckpt,
                                                "--pc", "x", "--out_pc_root", "y", "--device", "cpu"]))[1]
    torch.save({"base_model": model.state_dict()}, tmp_path / "w.pth")
    read = []
    real = native_io.read_cloud
    monkeypatch.setattr(native_io, "read_cloud", lambda p: read.append(p) or real(p))
    inference.main(["--model_config", TINY, "--model_checkpoint", str(tmp_path / "w.pth"), "--pc",
                    str(root / "cloud_pcd.pcd"), "--out_pc_root", str(tmp_path / "pth"), "--device", "cpu"])
    assert IO.use_native and read == [str(root / "cloud_pcd.pcd")]
    np.testing.assert_array_equal(np.load(tmp_path / "pth" / "cloud_pcd" / "fine.npy"), got["pcd"])


# --------------------------------------------------------- PCReconstructor


def test_pcreconstructor_serves_the_superset_like_jax(tmp_path, one_torch_thread):
    from PIL import Image

    sys.path.insert(0, str(REPO))
    from demo.pcreconstructor import PCReconstructor as JaxReconstructor

    jax_weights(SEG_TINY, tmp_path / "exp", seed=9)
    ckpt = str(tmp_path / "exp" / "ckpt-best.ckpt")
    IO.put(str(tmp_path / "cloud.pcd"), a_cloud(700, seed=1))  # fewer than 2048: tiled up
    rgb = (np.random.RandomState(2).rand(90, 120, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "view.png")
    classes = {"02691156": 0, "03001627": 3}
    inputs = (str(tmp_path / "cloud.pcd"), str(tmp_path / "view.png"), "03001627", classes)

    port = PCReconstructor(SEG_TINY, ckpt, device="cpu")
    assert port.inputs == ("partial", "img", "cls_vec")
    got = port.predict(*inputs)
    jax_rec = JaxReconstructor(SEG_TINY, ckpt)
    want = jax_rec.predict(*inputs)
    assert got.shape == want.shape == (1024, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=SERVE_ATOL)
    for ours, theirs in ((port.preprocess_point_cloud(inputs[0]), jax_rec.preprocess_point_cloud(inputs[0])),
                         (port.load_image(inputs[1]), jax_rec.load_image(inputs[1])),
                         (port.prepare_cls_vec(classes, "03001627"), jax_rec.prepare_cls_vec(classes, "03001627")),
                         (port.prepare_cls_vec(classes, "x"), jax_rec.prepare_cls_vec(classes, "x"))):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    # forward takes the decoded arrays; a missing input refuses
    np.testing.assert_array_equal(port.forward(port.preprocess_point_cloud(inputs[0]), port.load_image(inputs[1]),
                                               port.prepare_cls_vec(classes, "03001627")), got)
    with pytest.raises(ValueError, match="missing"):
        port.forward(port.preprocess_point_cloud(inputs[0]))


# ------------------------------------------------------------------ flags


def test_parser_takes_jax_flags(run_dir, capsys, monkeypatch):
    """The JAX parser's flags: ``--deterministic`` prints JAX's notice,
    ``--sync_bn`` one that says the statistics are the global batch's,
    ``--launcher pytorch`` and ``--local_rank`` take effect (a launch of
    several processes); ``--tp`` and ``--sp`` must divide the world, and
    above 1 they need a launch."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--config", TINY, "--deterministic", "--sync_bn", "--launcher", "pytorch", "--local_rank", "2"]
    args = port_parser.get_args(argv)
    ours = capsys.readouterr().out
    jargs = jax_parser.get_args(argv)
    theirs = capsys.readouterr().out
    assert ours.count("accepted for reference-CLI compatibility") == 2
    assert "[parser] --deterministic accepted" in ours and "[parser] --deterministic accepted" in theirs
    assert "global batch's statistics" in ours
    assert args.distributed and args.local_rank == 2 and args.launcher == "pytorch"
    assert (args.worker_mode, args.tp, args.sp, args.profile, args.wandb) == (
        jargs.worker_mode, jargs.tp, jargs.sp, jargs.profile, jargs.wandb) == ("thread", 1, 1, False, False)
    assert args.tfboard_path == os.path.join("experiments", "AdaPoinTr-tiny", "PCN_models", "TFBoard", "default")
    assert os.path.isdir(args.tfboard_path) and os.path.normpath(jargs.tfboard_path) == args.tfboard_path
    for flag in ("--tp", "--sp"):
        with pytest.raises(SystemExit):
            port_parser.get_args(["--config", TINY, flag, "2"])
        assert "launch one process a device" in capsys.readouterr().err
        monkeypatch.setenv("WORLD_SIZE", "3")
        with pytest.raises(SystemExit):
            port_parser.get_args(["--config", TINY, flag, "2"])
        assert "does not divide the world of 3 ranks" in capsys.readouterr().err
        monkeypatch.setenv("WORLD_SIZE", "4")
        assert getattr(port_parser.get_args(["--config", TINY, flag, "2"]), flag[2:]) == 2
        monkeypatch.delenv("WORLD_SIZE")
    assert not port_parser.get_args(["--config", TINY]).distributed
    port_parser.get_args(["--config", TINY, "--tp", "1", "--sp", "1", "--worker_mode", "process"])
    port_parser.get_args(["--config", TINY, "--test"])
    assert "[WARN] testing without --ckpts (random init)" in capsys.readouterr().out


def test_worker_modes_give_the_batches_of_zero_workers(pcn_root):
    """Threads and processes, 2 workers each, against 0 workers over two
    shuffled epochs of the PCN reader (which draws from each sample's
    seed): the same batches, bit for bit; ``close`` stops either pool."""
    ds = DATASETS.build(pcn_config(pcn_root, "train"))
    loaders = {(n, mode): Loader(ds, batch_size=2, shuffle=True, drop_last=True, seed=3, num_workers=n,
                                 worker_mode=mode) for n, mode in ((0, "thread"), (2, "thread"), (2, "process"))}
    with pytest.raises(ValueError, match="worker_mode"):
        Loader(ds, batch_size=2, shuffle=True, drop_last=True, worker_mode="fork")
    try:
        for epoch in (0, 1):
            epochs = {}
            for key, loader in loaders.items():
                loader.set_epoch(epoch)
                epochs[key] = list(loader)
                assert len(epochs[key]) == len(loader) == len(ds) // 2
            want = epochs[(0, "thread")]
            for key, got in epochs.items():
                for (gt, gm, gb), (wt, wm, wb) in zip(got, want):
                    assert gt == wt and gm == wm, key
                    assert all(torch.equal(gb[k], wb[k]) for k in wb), key
        processes = list(loaders[(2, "process")]._iterator._workers)
        threads = loaders[(2, "thread")]._pool
        assert threads is not None and processes
    finally:
        for loader in loaders.values():
            loader.close()
    assert loaders[(2, "thread")]._pool is None and threads._shutdown
    for w in processes:
        w.join(timeout=10)
        assert not w.is_alive()


def _scalars(path: pathlib.Path) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(path))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_profile_writers_wandb_and_the_rss_watchdog(run_dir, small_synthetic, monkeypatch, capfd,
                                                     one_torch_thread):
    """Two epochs of 2 steps with ``--profile --wandb`` (the epoch ends
    inside the profiler's window, which then stops with it and logs the
    port's spans of its one step; ``chip_smoke.py`` phase 10 runs the whole
    window), each epoch's line with the loader's counters; then the same
    run stopped by the RSS watchdog after epoch 0 and resumed: the final
    weights, BN statistics and AdamW state are the uninterrupted run's."""
    base = ["--config", TINY, "--synthetic", "--syn_train_len", str(2 * BS_SMALL), "--device", "cpu",
            "--num_workers", "0"]
    full = port_main.main(base + ["--exp_name", "full", "--profile", "--wandb"])
    log = capfd.readouterr().err
    assert "wandb requested but not installed; skipping" in log and full.step == 4
    tb = run_dir / "experiments" / "AdaPoinTr-tiny" / "PCN_models" / "TFBoard" / "full"
    (trace,) = tb.glob("*.pt.trace.json")
    assert f"profiler trace written to {trace.relative_to(run_dir)}" in log
    # the port's spans of the profiled step, by name, under the trace's line
    table = log.split("spans of the profiled steps:\n", 1)[1].splitlines()
    assert table[0].split() == ["span", "calls", "host", "ms", "host", "self", "device", "ms", "device", "self"]
    rows = {line.split()[0]: line.split()[1:] for line in table[1:13]}
    assert set(rows) == {"runner.train_step", "runner.augment", "runner.forward", "model.grouper", "model.encoder",
                         "model.query", "model.decoder", "model.head", "runner.loss", "runner.backward",
                         "runner.clip", "runner.optimizer"}
    assert all(r[0] == "1" and r[3:] == ["-", "-"] for r in rows.values())  # one step; no device on the CPU
    # each epoch's line carries the loader's counters (0 workers: the decode is the wait's)
    epochs = [line for line in log.splitlines() if "[Training] EPOCH" in line]
    assert len(epochs) == 2 and all("Loader = 2 batches, wait " in line for line in epochs)
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"aten::sort", "aten::mm"} <= names  # the plain kNN's sort, the linear layers
    train, test = _scalars(tb / "train"), _scalars(tb / "test")
    assert set(train) == {"Loss/Batch/Sparse", "Loss/Batch/Dense", "LR/Batch", "Loss/Epoch/Sparse",
                          "Loss/Epoch/Dense"}
    assert set(test) == {"Loss/Epoch/Sparse", "Loss/Epoch/Dense"} | {f"Metric/{n}" for n in METRIC_NAMES}
    assert [s for s, _ in train["Loss/Batch/Sparse"]] == [0, 2] and [s for s, _ in test["Metric/CDL1"]] == [0, 1]
    assert train["LR/Batch"][0][1] == pytest.approx(5e-4)

    monkeypatch.setenv("IMGADAPOINTR_RSS_LIMIT_GB", "1e-6")
    with pytest.raises(SystemExit) as stop:
        port_main.main(base + ["--exp_name", "rss"])
    assert stop.value.code == 75 and "[rss-watchdog]" in capfd.readouterr().err
    exp = run_dir / "experiments" / "AdaPoinTr-tiny" / "PCN_models" / "rss"
    assert (exp / "ckpt-last.pth").exists() and not (exp / "ckpt-epoch-001.pth").exists()
    monkeypatch.delenv("IMGADAPOINTR_RSS_LIMIT_GB")
    resumed = port_main.main(base + ["--exp_name", "rss", "--resume"])
    assert "Resumed from epoch 1 (ckpt-last.pth)" in capfd.readouterr().err and resumed.step == 4
    for (n, a), (_, b) in zip(full.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    want, got = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k][f], got[k][f]) for k in want for f in want[k])


def test_test_without_ckpts_warns_then_refuses(run_dir, small_synthetic, capfd):
    """As in the JAX package: its parser warns (``utils/parser.py:94-95``),
    then its ``test_net`` refuses a random init (``tools/runner.py:759-762``)."""
    with pytest.raises(ValueError, match="--ckpts"):
        port_main.main(["--config", TINY, "--exp_name", "t", "--synthetic", "--test", "--no_emd",
                        "--device", "cpu", "--num_workers", "0"])
    assert "[WARN] testing without --ckpts (random init)" in capfd.readouterr().out


def test_rss_watchdog_reads_the_current_rss(monkeypatch, tmp_path):
    """``host_rss_gb`` is ``VmRSS``, not the peak ``VmHWM``: after a spike
    that has dropped, the watchdog goes on; over the limit it saves
    ``ckpt-last`` (on an epoch that did not) and exits 75."""
    from imgadapointr_tpu_torch.parallel.mesh import make_mesh

    status = {"text": "VmHWM:\t90000000 kB\nVmRSS:\t  500000 kB\n"}  # an 90 GB spike, 0.5 GB now
    monkeypatch.setattr(port_runner, "_proc_status", lambda: status["text"])
    monkeypatch.setenv("IMGADAPOINTR_RSS_LIMIT_GB", "10")
    assert port_runner.host_rss_gb() == 0.5
    saved = []
    runner = types.SimpleNamespace(mesh=make_mesh(), save=lambda *a: saved.append(a))
    port_runner.rss_watchdog(runner, 0, 5, False, None, "silent")  # goes on
    assert saved == []
    status["text"] = "VmHWM:\t90000000 kB\nVmRSS:\t20000000 kB\n"
    with pytest.raises(SystemExit) as stop:
        port_runner.rss_watchdog(runner, 1, 5, False, None, "silent")
    assert stop.value.code == 75 and [a[0] for a in saved] == ["ckpt-last"]
    port_runner.rss_watchdog(runner, 4, 5, False, None, "silent")  # not after the last epoch
    # the real reader, on this process: a 200 MB spike is gone from VmRSS once freed
    monkeypatch.undo()
    spike = np.ones(200 * 2**20 // 8)
    high = port_runner.host_rss_gb()
    del spike
    assert 0 < port_runner.host_rss_gb() < high - 0.1
