"""``.h5`` clouds without h5py and the renders without matplotlib, on the CPU.

- ``IO.get`` of the port (``utils/hdf5.py``) equals the JAX package's
  ``IO.get`` (h5py) bit for bit on files h5py writes in the layouts the
  reader takes: the default (contiguous), chunked through gzip and shuffle
  with a partial edge chunk, chunks enough for a two-level B-tree, float64,
  big-endian ``>f4``, compact, int16, a user block, a dataset whose header
  continues in a second block; ``IO.put(".h5")`` is read back by h5py bit
  for bit; a ``libver="latest"`` file, a variable-length type and the lzf
  filter raise ``NotImplementedError`` naming what they are.
- ``utils/render.py`` against matplotlib on JAX's two figures, built as
  ``imgadapointr_tpu/tools/runner.py:920-928`` and
  ``imgadapointr_tpu/tools/inference.py:113-118`` build them: after
  ``fig.canvas.draw()``, each point's display position within 0.5 px of
  ``ax.transData.transform(sc.get_offsets())`` and its alpha in draw order
  within 1e-6 of ``sc.get_facecolors()[:, 3]``.
- The JPEGs of JAX's ``_save_vis`` and of JAX's ``_test_kitti`` (a stub
  runner returning fixed clouds) against the port's ``save_vis`` and
  ``_test_kitti``: the same size, and the masks of inked pixels (some
  channel below ``255 - INK``) outside the title band with an IoU at or
  above ``IOU_BAND``.
"""

import types

import h5py
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from imgadapointr_tpu.tools import inference as jax_inference
from imgadapointr_tpu.tools import runner as jax_runner
from imgadapointr_tpu.utils.io_module import IO as JaxIO
from imgadapointr_tpu_torch.tools import inference as port_inference
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.utils import hdf5, render
from imgadapointr_tpu_torch.utils.io_module import IO

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402  (after the backend)

INK = 30  # a pixel is inked where some channel is below 255 - INK
# IoU of the ink masks, the port's JPEG against matplotlib's, with the
# clouds below (matplotlib 3.10.8, PIL 12.1.0, measured on this test's
# clouds): the KITTI images 0.9781 and 0.9809; the CLI's input.jpg 0.9448
# and fine.jpg 0.9965. Each band is the lower measured value less 0.05.
IOU_BAND = {"kitti": 0.9281, "cli": 0.8948}


def a_cloud(n=1001, seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal((n, 3)) * [1.0, 0.5, 0.25]).astype(dtype)


def _compact(f, arr):
    space = h5py.h5s.create_simple(arr.shape)
    plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    plist.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, b"data", h5py.h5t.NATIVE_FLOAT, space, plist).write(h5py.h5s.ALL, h5py.h5s.ALL, arr)


def _continued(f, arr):
    d = f.create_dataset("data", data=arr, chunks=(50, 3), compression="gzip", shuffle=True)
    for i in range(30):  # the attributes overflow the first header block into a continuation
        d.attrs[f"a{i}"] = np.arange(20) * i


LAYOUTS = {
    "default": lambda f, a: f.create_dataset("data", data=a),
    "gzip_shuffle_edge": lambda f, a: f.create_dataset("data", data=a, chunks=(128, 3), compression="gzip",
                                                       shuffle=True),
    "two_level_btree": lambda f, a: f.create_dataset("data", data=a, chunks=(8, 3)),
    "float64": lambda f, a: f.create_dataset("data", data=a.astype(np.float64)),
    "big_endian_f4": lambda f, a: f.create_dataset("data", data=a.astype(">f4")),
    "compact": lambda f, a: _compact(f, a[:40].copy()),
    "int16": lambda f, a: f.create_dataset("data", data=(a * 1000).astype(np.int16)),
    "continuation": _continued,
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_h5_reads_equal_jax(tmp_path, layout):
    path = str(tmp_path / "c.h5")
    kw = {"userblock_size": 512} if layout == "default" else {}
    with h5py.File(path, "w", **kw) as f:
        f.create_dataset("other", data=np.arange(7))
        LAYOUTS[layout](f, a_cloud())
    got, want = IO.get(path), JaxIO.get(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["<f4", "<f8", ">f4", "<i4"])
def test_h5_writes_read_back_by_h5py(tmp_path, dtype):
    arr = (a_cloud(777, seed=1) * (100 if dtype == "<i4" else 1)).astype(dtype)
    path = str(tmp_path / "w.h5")
    IO.put(path, arr)
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == ["data"]
        back = f["data"][()]
    assert back.shape == arr.shape and back.dtype.newbyteorder("=") == arr.dtype.newbyteorder("=")
    assert back.astype(arr.dtype).tobytes() == arr.tobytes()
    assert hdf5.read(path).tobytes() == back.tobytes()
    np.testing.assert_array_equal(IO.get(path), JaxIO.get(path))


def _latest(f):
    f.create_dataset("data", data=a_cloud())


REFUSED = {
    "superblock version 3": ({"libver": "latest"}, _latest),
    "variable-length datatype": ({}, lambda f: f.create_dataset("data", data=["a", "bb"],
                                                                dtype=h5py.string_dtype())),
    "filter 32000 (lzf)": ({}, lambda f: f.create_dataset("data", data=a_cloud(), chunks=(100, 3),
                                                          compression="lzf")),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_h5_refuses_and_names_what_it_met(tmp_path, what):
    kw, make = REFUSED[what]
    path = str(tmp_path / "r.h5")
    with h5py.File(path, "w", **kw) as f:
        make(f)
    with pytest.raises(NotImplementedError, match=what.replace("(", r"\(").replace(")", r"\)")):
        IO.get(path)


# ------------------------------------------------------------------ renders


def _surface(n, seed, half=False):
    """Points on an ellipsoid (one side of it with ``half``), a car's proportions."""
    p = np.random.default_rng(seed).standard_normal((n, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True) * [2.0, 0.9, 0.7]
    return (p[p[:, 1] > -0.2] if half else p).astype(np.float32)


PARTIAL, DENSE = _surface(2400, 5, half=True), _surface(16384, 6)


def kitti_figure(partial, dense):
    """JAX's KITTI figure (``imgadapointr_tpu/tools/runner.py:920-928``)."""
    fig, axes = plt.subplots(1, 2, figsize=(8, 4), subplot_kw={"projection": "3d"})
    scs = []
    for ax, cloud, name in zip(axes, (partial, dense), ("input", "prediction")):
        scs.append(ax.scatter(cloud[:, 0], cloud[:, 1], cloud[:, 2], s=0.4))
        ax.set_title(name)
        ax.set_axis_off()
    return fig, list(axes), scs, 100


def cli_figure(cloud):
    """JAX's CLI figure (``imgadapointr_tpu/tools/inference.py:113-118``), at its savefig dpi."""
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(cloud[:, 0], cloud[:, 1], cloud[:, 2], s=0.5)
    ax.set_axis_off()
    fig.set_dpi(120)
    return fig, [ax], [sc], 120


@pytest.mark.parametrize("figure", ["kitti", "cli_input", "cli_fine"])
def test_render_geometry_matches_matplotlib(figure):
    if figure == "kitti":
        fig, axes, scs, dpi = kitti_figure(PARTIAL, DENSE)
        clouds, figsize = (PARTIAL, DENSE), (8, 4)
    else:
        cloud = PARTIAL if figure == "cli_input" else DENSE
        fig, axes, scs, dpi = cli_figure(cloud)
        clouds, figsize = (cloud,), (4, 4)
    try:
        fig.canvas.draw()
        w, h = fig.canvas.get_width_height()
        assert (w, h) == (figsize[0] * dpi, figsize[1] * dpi)
        for ax, sc, cloud, box in zip(axes, scs, clouds, render.axes_boxes(len(clouds), figsize)):
            xy, alpha, order = render.project(cloud, (box[0] * w, box[1] * h, box[2] * w, box[3] * h))
            want = ax.transData.transform(sc.get_offsets())
            assert np.abs(xy - want).max() <= 0.5
            np.testing.assert_allclose(alpha[order], sc.get_facecolors()[:, 3], rtol=0, atol=1e-6)
    finally:
        plt.close(fig)


def ink_iou(a_path, b_path, band_rows: int) -> float:
    """IoU of the inked pixels of two JPEGs below the first ``band_rows`` rows."""
    with Image.open(a_path) as a, Image.open(b_path) as b:
        assert a.size == b.size
        ia = np.asarray(a.convert("RGB")).min(-1)[band_rows:] < 255 - INK
        ib = np.asarray(b.convert("RGB")).min(-1)[band_rows:] < 255 - INK
    return float((ia & ib).sum() / (ia | ib).sum())


def test_save_vis_images_match_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_inference._save_vis(str(tmp_path / "jax"), PARTIAL, DENSE)
    port_inference.save_vis(str(tmp_path / "port"), PARTIAL, DENSE)
    for name in ("input.jpg", "fine.jpg"):
        with Image.open(tmp_path / "port" / name) as im:
            assert (im.format, im.size) == ("JPEG", (480, 480))
        assert ink_iou(tmp_path / "jax" / name, tmp_path / "port" / name, 0) >= IOU_BAND["cli"], name


class _Batches:
    """Two KITTI test batches of fixed clouds at batch 1."""

    def __init__(self, tensors: bool):
        self.tensors = tensors

    def __iter__(self):
        for i, partial in enumerate((PARTIAL, PARTIAL[::2].copy())):
            yield ["cars"], [f"frame_{i}_car_0"], {"partial": torch.from_numpy(partial[None]) if self.tensors
                                                   else partial[None]}


def test_kitti_images_match_jax(tmp_path):
    jax_stub = types.SimpleNamespace(eval_step=lambda state, batch: (None, (None, DENSE[None])))
    port_stub = types.SimpleNamespace(_to_device=lambda batch: batch,
                                      predict=lambda batch: (None, torch.from_numpy(DENSE[None])))
    jax_args = types.SimpleNamespace(experiment_path=str(tmp_path / "jax"))
    port_args = types.SimpleNamespace(experiment_path=str(tmp_path / "port"))
    assert jax_runner._test_kitti(jax_stub, None, _Batches(False), jax_args, None, "silent") == {}
    assert port_runner._test_kitti(port_stub, _Batches(True), port_args, None, "silent") == {}
    names = sorted(p.name for p in (tmp_path / "jax" / "vis_result").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" / "vis_result").iterdir()) == [
        "frame_0_car_0_000.jpg", "frame_1_car_0_001.jpg"]
    _, bottom, _, height = render.axes_boxes(2, (8, 4))[0]
    title_rows = int(np.ceil(400 * (1 - bottom - height)))  # the rows above the axes hold the titles
    for name in names:
        with Image.open(tmp_path / "port" / "vis_result" / name) as im:
            assert (im.format, im.size) == ("JPEG", (800, 400))
        iou = ink_iou(tmp_path / "jax" / "vis_result" / name, tmp_path / "port" / "vis_result" / name, title_rows)
        assert iou >= IOU_BAND["kitti"], (name, iou)
