"""The port's on-disk data path against the JAX package, on the CPU.

Point-cloud IO, the PCN, ShapeNet-55 and KITTI readers, the loader's order
and the crop and dropping ops, each held to the JAX package's counterpart
on the same fixture, index and seed. Fixtures are small trees written into
a temporary directory; no dataset is downloaded.

Tolerances: none. A reader or the loader must give JAX's arrays bit for
bit (both run the same numpy arithmetic on the same generator stream), and
the sampling ops, handed JAX's draws, JAX's indices and points in float64.
The JAX ``IO`` runs its pure-Python parsers (``use_native`` off): those are
what the port copies.

The sampling ops' clouds lie on a lattice (coordinates k/64), as in
``tests/test_torch_scatter_mxu.py``: every FPS distance is then exact in
JAX's float32 matmul form and in the port's float64 diff form, so the picks
compare, and equal distances abound (the first index must win on both
sides). The crops' view distances are held to their pinned arithmetic
and, in float64, to JAX's order on random clouds as well.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgadapointr_tpu.datasets import pcn_dataset as jax_pcn
from imgadapointr_tpu.datasets import shapenet55 as jax_shapenet
from imgadapointr_tpu.datasets.loader import DataLoader as JaxLoader
from imgadapointr_tpu.ops import pointops as jax_pointops
from imgadapointr_tpu.ops import sampling as jax_sampling
from imgadapointr_tpu.utils.config import AttrDict as JaxAttrDict
from imgadapointr_tpu.utils.io_module import IO as JaxIO
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.datasets import DATASETS
from imgadapointr_tpu_torch.datasets.loader import Loader, base_seed
from imgadapointr_tpu_torch.ops import sampling
from imgadapointr_tpu_torch.tools.builder import dataset_builder
from imgadapointr_tpu_torch.utils.config import AttrDict
from imgadapointr_tpu_torch.utils.io_module import IO

TAXONOMIES = ("02691156", "02958343", "03001627")  # airplane (a segmentation class), car, chair
PARTIAL_SIZES = (300, 2500, 2048)  # below, above and at RandomSamplePoints' 2048
IMAGE_SIZES = ((40, 30), (30, 40), (24, 24))  # (w, h): both resize branches and a square


@pytest.fixture(autouse=True)
def jax_pure_python_io(monkeypatch):
    monkeypatch.setattr(JaxIO, "use_native", False)


# ------------------------------------------------------------------ fixtures


def _cloud(rng, n):
    return (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def pcn_root(tmp_path_factory):
    """A PCN tree in the layout of ``cfgs/dataset_configs/PCN.yaml``: three
    taxonomies, 2 renders a train model, partials of 300, 2500 and 2048
    points, 1024-point complete clouds, and 24 PNG renders a model of three
    sizes."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pcn")
    rng = np.random.default_rng(3)
    cats = [{"taxonomy_id": t, "taxonomy_name": t,
             "train": [f"{t[-3:]}m{i}" for i in range(3)], "val": [f"{t[-3:]}v0"],
             "test": [f"{t[-3:]}t0", f"{t[-3:]}t1"]} for t in TAXONOMIES]
    (root / "PCN.json").write_text(json.dumps(cats))
    n = 0
    for dc in cats:
        for subset in ("train", "val", "test"):
            for m in dc[subset]:
                for r in range(2 if subset == "train" else 1):
                    path = root / subset / "partial" / dc["taxonomy_id"] / m / f"{r:02d}.pcd"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    IO.put(str(path), _cloud(rng, PARTIAL_SIZES[n % 3]))
                    n += 1
                path = root / subset / "complete" / dc["taxonomy_id"] / f"{m}.pcd"
                path.parent.mkdir(parents=True, exist_ok=True)
                IO.put(str(path), _cloud(rng, 1024))
                for v in range(24):
                    path = root / subset / "render" / dc["taxonomy_id"] / m / f"{v:02d}.png"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    w, h = IMAGE_SIZES[(n + v) % 3]
                    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    return root


def pcn_config(root, subset, name="PCN", cars=False, attr=AttrDict):
    return attr({
        "NAME": name, "CATEGORY_FILE_PATH": str(root / "PCN.json"), "N_POINTS": 1024, "N_RENDERINGS": 2,
        "PARTIAL_POINTS_PATH": str(root / "%s/partial/%s/%s/%02d.pcd"),
        "COMPLETE_POINTS_PATH": str(root / "%s/complete/%s/%s.pcd"),
        "IMG_PATH": str(root / "%s/render/%s/%s/%02d.png"), "CARS": cars, "others": {"subset": subset},
    })


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    """A ShapeNet-55 tree: ``train.txt`` / ``test.txt`` lines naming ``.npy``
    clouds of 300 and 200 points (above and below ``N_POINTS`` 256)."""
    root = tmp_path_factory.mktemp("shapenet")
    (root / "pc").mkdir()
    rng = np.random.default_rng(4)
    for subset, n_models in (("train", 4), ("test", 3)):
        lines = []
        for i in range(n_models):
            line = f"{TAXONOMIES[i % 3]}-{subset}{i}x.npy"
            IO.put(str(root / "pc" / line), _cloud(rng, 300 if i % 2 == 0 else 200))
            lines.append(line)
        (root / f"{subset}.txt").write_text("\n".join(lines) + "\n")
    return root


def shapenet_config(root, subset, attr=AttrDict):
    return attr({"NAME": "ShapeNet", "DATA_PATH": str(root), "PC_PATH": str(root / "pc"),
                 "N_POINTS": 256, "others": {"subset": subset}})


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """KITTI car scans (``.pcd``) of 100 and 700 points (below and above
    ``N_POINTS`` 512) and their 8-corner boxes (``.txt``)."""
    root = tmp_path_factory.mktemp("kitti")
    (root / "cars").mkdir()
    (root / "bboxes").mkdir()
    rng = np.random.default_rng(5)
    names = ["frame_0_car_0", "frame_1_car_2", "frame_3_car_1"]
    for i, s in enumerate(names):
        IO.put(str(root / "cars" / f"{s}.pcd"), _cloud(rng, (100, 700, 512)[i]) + 5.0)
        yaw = rng.uniform(-np.pi, np.pi)
        corners = np.array([[x, y, z] for z in (0, 1.5) for x, y in ((-2, -1), (-2, 1), (2, 1), (2, -1))])
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        IO.put(str(root / "bboxes" / f"{s}.txt"), (corners @ rot.T + 5.0).astype(np.float32))
    (root / "KITTI.json").write_text(json.dumps(names))
    return root


def kitti_config(root, attr=AttrDict):
    return attr({"NAME": "KITTI", "CATEGORY_FILE_PATH": str(root / "KITTI.json"), "N_POINTS": 512,
                 "CLOUD_PATH": str(root / "cars/%s.pcd"), "BBOX_PATH": str(root / "bboxes/%s.txt"),
                 "CARS": True, "others": {"subset": "test"}})


def assert_samples_equal(got, want):
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        assert got[2][k].dtype == want[2][k].dtype, k
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)


# ------------------------------------------------------------------------ IO


@pytest.mark.parametrize("ext", [".npy", ".npz", ".pcd", ".ply", ".h5", ".txt", ".dat", ".xyz"])
def test_io_round_trip_and_jax_reads_the_same(tmp_path, ext):
    """Every format the port writes reads back unchanged, and the JAX
    package's IO reads the same file into the same array."""
    pts = _cloud(np.random.default_rng(0), 257)
    path = str(tmp_path / f"cloud{ext}")
    IO.put(path, pts)
    got = IO.get(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(got, JaxIO.get(path))


def _write(path, text: str, body: bytes = b""):
    with open(path, "wb") as f:
        f.write(text.encode("ascii") + body)


def test_io_reads_the_layouts_jax_reads(tmp_path):
    """Layouts no ``IO.put`` writes: ASCII ``.pcd``, binary ``.pcd`` with
    an extra field before x, ASCII ``.ply`` with extra properties, each
    read as JAX reads it; and binary ``.ply`` with a face element after the
    vertices, which the port reads and the JAX parser refuses."""
    rng = np.random.default_rng(1)
    pts = _cloud(rng, 50)
    rgb = rng.integers(0, 2**31, 50).astype("<u4")
    files = {}
    files["ascii.pcd"] = ("# comment\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                          "WIDTH 50\nHEIGHT 1\nPOINTS 50\nDATA ascii\n"
                          + "".join(f"{x!r} {y!r} {z!r}\n" for x, y, z in pts.tolist()), b"")
    rec = np.zeros(50, dtype=[("rgb", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("n", "<f8", (2,))])
    rec["rgb"], rec["x"], rec["y"], rec["z"] = rgb, pts[:, 0], pts[:, 1], pts[:, 2]
    files["fields.pcd"] = ("VERSION 0.7\nFIELDS rgb x y z n\nSIZE 4 4 4 4 8\nTYPE U F F F F\nCOUNT 1 1 1 1 2\n"
                           "WIDTH 50\nHEIGHT 1\nPOINTS 50\nDATA binary\n", rec.tobytes())
    files["ascii.ply"] = ("ply\nformat ascii 1.0\nelement vertex 50\nproperty float nx\nproperty float x\n"
                          "property float y\nproperty float z\nend_header\n"
                          + "".join(f"0.5 {x!r} {y!r} {z!r}\n" for x, y, z in pts.tolist()), b"")
    vert = np.zeros(50, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1")])
    vert["x"], vert["y"], vert["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    files["faces.ply"] = ("ply\nformat binary_little_endian 1.0\nelement vertex 50\nproperty float x\n"
                          "property float y\nproperty float z\nproperty uchar red\nelement face 1\n"
                          "property list uchar int vertex_indices\nend_header\n", vert.tobytes() + b"\x03" * 13)
    for name, (header, body) in files.items():
        path = str(tmp_path / name)
        _write(path, header, body)
        got = IO.get(path)
        np.testing.assert_array_equal(got, pts, err_msg=name)
        if name == "faces.ply":  # the JAX parser drops the vertex properties once a face element follows
            with pytest.raises(TypeError):
                JaxIO.get(path)
        else:
            np.testing.assert_array_equal(got, JaxIO.get(path), err_msg=name)


def test_io_refuses_unknown_extensions_and_truncated_headers(tmp_path):
    for call in (lambda: IO.get(str(tmp_path / "a.obj")), lambda: IO.put(str(tmp_path / "a.obj"), np.zeros((2, 3)))):
        with pytest.raises(ValueError, match="Unsupported file extension"):
            call()
    _write(str(tmp_path / "cut.pcd"), "VERSION 0.7\nFIELDS x y z\n")
    _write(str(tmp_path / "cut.ply"), "ply\nformat ascii 1.0\n")
    for name in ("cut.pcd", "cut.ply"):
        with pytest.raises(ValueError, match="truncated"):
            IO.get(str(tmp_path / name))


# ------------------------------------------------------------------- readers


@pytest.mark.parametrize("name", ["PCN", "PCNv2", "ImgPCN", "SegImgPCN"])
@pytest.mark.parametrize("subset", ["train", "val", "test"])
def test_pcn_readers_match_jax(pcn_root, name, subset):
    """Each sample of each subset, bit for bit: the render pick, the
    partial's sampling (300 and 2500 points: padded and cut) or tiling, the
    mirror, the image's resize (non-square renders) and the class one-hot."""
    port = DATASETS.build(pcn_config(pcn_root, subset, name))
    ref = getattr(jax_pcn, name)(pcn_config(pcn_root, subset, name, attr=JaxAttrDict))
    assert len(port) == len(ref) == 3 * {"train": 3, "val": 1, "test": 2}[subset]
    for i in range(len(port)):
        for seed in (0, 7):
            got = port.get(i, np.random.default_rng((seed, i)))
            assert_samples_equal(got, ref.get(i, np.random.default_rng((seed, i))))
        if subset == "train":
            assert got[2]["partial"].shape == (2048, 3)


def test_pcn_cars_keeps_the_car_taxonomy(pcn_root):
    port = DATASETS.build(pcn_config(pcn_root, "train", cars=True))
    ref = jax_pcn.PCN(pcn_config(pcn_root, "train", cars=True, attr=JaxAttrDict))
    assert len(port) == len(ref) == 3
    for i in range(3):
        got = port.get(i, np.random.default_rng(i))
        assert got[0] == "02958343"
        assert_samples_equal(got, ref.get(i, np.random.default_rng(i)))


@pytest.mark.parametrize("subset", ["train", "test"])
def test_shapenet_reader_matches_jax(shapenet_root, subset):
    port = DATASETS.build(shapenet_config(shapenet_root, subset))
    ref = jax_shapenet.ShapeNet55(shapenet_config(shapenet_root, subset, attr=JaxAttrDict))
    assert len(port) == len(ref) == {"train": 4, "test": 3}[subset]
    for i in range(len(port)):
        got = port.get(i, np.random.default_rng((1, i)))
        assert_samples_equal(got, ref.get(i, np.random.default_rng((1, i))))
        assert got[2]["gt"].shape == (256, 3) and got[2]["partial"] is got[2]["gt"]
    assert port.file_list[0]["model_id"] == f"{subset}0x"


def test_kitti_reader_matches_jax(kitti_root):
    port = DATASETS.build(kitti_config(kitti_root))
    ref = jax_shapenet.KITTI(kitti_config(kitti_root, attr=JaxAttrDict))
    for i in range(len(port)):
        got = port.get(i, np.random.default_rng(i))
        assert_samples_equal(got, ref.get(i, np.random.default_rng(i)))
        assert got[2]["partial"].shape == (512, 3) and got[2]["gt"].shape == (1, 3)


# -------------------------------------------------------------------- loader


def _jax_batches(dataset, bs, shuffle, epochs, seed):
    loader = JaxLoader(dataset, bs, shuffle=shuffle, drop_last=shuffle, seed=seed, num_workers=2)
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.append(list(loader))
    loader.close()
    return out


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_matches_jax_over_two_epochs(pcn_root, num_workers):
    """The train split (shuffled, ragged batch dropped) over epochs 0 and 1,
    and the val split (in order), from ``dataset_builder``: JAX's batches,
    in JAX's order, bit for bit; 2 worker processes give the same."""
    args = type("Args", (), {"seed": 5, "num_workers": num_workers})()
    for subset, bs in (("train", 2), ("test", 4)):
        cfg = pcn_config(pcn_root, subset, "SegImgPCN")
        cfg.others.bs = bs
        _, loader = dataset_builder(args, cfg)
        want = _jax_batches(jax_pcn.SegImgPCN(pcn_config(pcn_root, subset, "SegImgPCN", attr=JaxAttrDict)),
                            bs, subset == "train", (0, 1), 5)
        for e, want_epoch in zip((0, 1), want):
            loader.set_epoch(e)
            got_epoch = list(loader)
            assert len(got_epoch) == len(want_epoch) == len(loader)
            for (gt_ids, gm_ids, gb), (wt_ids, wm_ids, wb) in zip(got_epoch, want_epoch):
                assert gt_ids == wt_ids and gm_ids == wm_ids
                assert gb.keys() == wb.keys()
                for k in wb:
                    np.testing.assert_array_equal(gb[k].numpy(), wb[k], err_msg=k)
        if subset == "train":
            assert len(loader) == 9 // 2
            orders = [[m for _, mids, _ in epoch for m in mids] for epoch in want]
            assert orders[0] != orders[1]
        workers = list(loader._iterator._workers) if num_workers else []
        loader.close()
        for w in workers:
            w.join(timeout=10)
            assert not w.is_alive()


def test_loader_seeds_each_sample_by_epoch_and_index(pcn_root):
    """Sample i of epoch e draws from ``default_rng((base_seed(seed, e), i))``."""
    ds = DATASETS.build(pcn_config(pcn_root, "train"))
    loader = Loader(ds, batch_size=1, shuffle=True, drop_last=True, seed=3)
    loader.set_epoch(4)
    order = np.random.default_rng(3 + 4).permutation(len(ds))
    assert base_seed(3, 4) == (3 * 7919 + 4) & 0x7FFFFFFF
    for i, (tax, mids, batch) in zip(order, loader):
        want = ds.get(int(i), np.random.default_rng((base_seed(3, 4), int(i))))
        assert [want[1]] == mids
        np.testing.assert_array_equal(batch["partial"][0].numpy(), want[2]["partial"])


def test_loader_close_raises_without_the_shutdown_hook(pcn_root):
    """``close`` relies on the DataLoader iterator's private
    ``_shutdown_workers``; an iterator without it raises instead of
    leaving the workers running. A loader never iterated closes quietly."""
    ds = DATASETS.build(pcn_config(pcn_root, "train"))
    loader = Loader(ds, batch_size=1, shuffle=False, drop_last=False)
    loader.close()
    loader._iterator = object()
    with pytest.raises(RuntimeError, match="_shutdown_workers"):
        loader.close()


# ------------------------------------------------------------- sampling ops


def lattice(rng, *shape):
    """Coordinates k/64, |k| <= 32: every product and sum of FPS exact."""
    return rng.integers(-32, 33, shape).astype(np.float64) / 64.0


def with_ties(rng, b, n):
    """A lattice cloud whose second half repeats points of its first, so
    that equal distances (to any view point) fall at distinct indices."""
    pts = lattice(rng, b, n, 3)
    pts[:, n // 2:] = pts[:, rng.integers(0, n // 2, n - n // 2)]
    return pts


def x64(fn):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_view_distance_is_pinned_and_orders_as_jax(dtype):
    """The crops' sort key is ``sqrt((dx² + dy²) + dz²)``, each operation
    rounded: in float32 numpy's arithmetic bit for bit (the card's
    elementwise kernels and its correctly rounded root give the same), in
    float64 within an ulp (PyTorch's vectorised CPU root); sorted stably
    (duplicated points keep their index order). XLA:CPU contracts JAX's
    ``linalg.norm`` into FMAs, so its last bit can differ; in float64 the
    order is ``jnp.argsort``'s all the same."""
    rng = np.random.default_rng(2)
    xyz = rng.standard_normal((3, 4000, 3)).astype(dtype)
    xyz[:, 2000:] = xyz[:, :2000]
    center = rng.standard_normal((3, 1, 3)).astype(dtype)
    d = center - xyz
    want_d = np.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])
    got_d = sampling._norm3(torch.from_numpy(center) - torch.from_numpy(xyz)).numpy()
    assert got_d.dtype == want_d.dtype == dtype
    if dtype == np.float32:
        np.testing.assert_array_equal(got_d, want_d)
    else:
        np.testing.assert_allclose(got_d, want_d, rtol=np.finfo(dtype).eps, atol=0)
    order = sampling.view_order(torch.from_numpy(xyz), torch.from_numpy(center)).numpy()
    np.testing.assert_array_equal(order, np.argsort(got_d, axis=-1, kind="stable"))
    assert (order[:, 1:] > order[:, :-1])[np.diff(np.take_along_axis(got_d, order, -1), axis=-1) == 0].all()
    assert (np.diff(np.take_along_axis(got_d, order, -1), axis=-1) == 0).sum() >= 3 * 2000
    if dtype == np.float64:
        jax_order = x64(lambda: np.asarray(jnp.argsort(
            jnp.linalg.norm(jnp.asarray(center) - jnp.asarray(xyz), axis=-1), axis=-1)))
        np.testing.assert_array_equal(order, jax_order)


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("padding_zeros", [False, True])
def test_separate_point_cloud_matches_jax(fixed, padding_zeros):
    """A fixed viewpoint (used raw) and a random centre (JAX's normal draw,
    normalised on both sides), on clouds with exact distance ties."""
    rng = np.random.default_rng(6)
    xyz = with_ties(rng, 3, 256)
    key = jax.random.PRNGKey(9)

    def ref():
        kw = {"fixed_point": jnp.asarray((1.0, -1.0, 1.0))} if fixed else {"key": key}
        inp, crop = jax_sampling.separate_point_cloud(jnp.asarray(xyz), 96, padding_zeros=padding_zeros, **kw)
        return np.array(inp), np.array(crop), np.array(jax.random.normal(key, (3, 1, 3)))

    want_in, want_crop, center = x64(ref)
    kw = {"fixed_point": (1.0, -1.0, 1.0)} if fixed else {"center": torch.from_numpy(center)}
    got_in, got_crop = sampling.separate_point_cloud(torch.from_numpy(xyz), 96, padding_zeros=padding_zeros, **kw)
    np.testing.assert_array_equal(got_crop.numpy(), want_crop)
    np.testing.assert_array_equal(got_in.numpy(), want_in)


def test_train_random_crop_matches_jax():
    """JAX's key split as JAX splits it: the centre and the crop sizes go
    to the port; the sorted order, the kept cloud (the dropped rows copies
    of the farthest point), the FPS picks and the output agree."""
    rng = np.random.default_rng(8)
    B, N, out = 4, 256, 64
    gt = with_ties(rng, B, N)
    key = jax.random.PRNGKey(11)

    def ref():
        k_center, k_crop = jax.random.split(key)
        center = jax.random.normal(k_center, (B, 1, 3))
        num_crop = jax.random.randint(k_crop, (B, 1), N // 4, 3 * N // 4 + 1)
        got = jax_sampling.train_random_crop(key, jnp.asarray(gt), N, out)
        unit = center / jnp.linalg.norm(center, axis=-1, keepdims=True)
        order = jnp.argsort(jnp.linalg.norm(unit - jnp.asarray(gt), axis=-1), axis=-1)
        return [np.array(a) for a in (got, center, num_crop, order)]

    want, center, num_crop, order = x64(ref)
    assert num_crop.min() >= N // 4 and num_crop.max() <= 3 * N // 4
    t_center, t_crop = torch.from_numpy(center), torch.from_numpy(num_crop)
    unit = sampling._unit_center(t_center)
    np.testing.assert_array_equal(sampling.view_order(torch.from_numpy(gt), unit).numpy(), order)
    kept = sampling.train_crop_kept(torch.from_numpy(gt), unit, t_crop)
    for b in range(B):
        tail = gt[b, order[b, -1]]
        assert (kept[b, :num_crop[b, 0]].numpy() == tail).all()
        np.testing.assert_array_equal(kept[b, num_crop[b, 0]:].numpy(), gt[b, order[b, num_crop[b, 0]:]])
    got = sampling.train_random_crop(torch.from_numpy(gt), N, out, center=t_center, num_crop=t_crop)
    np.testing.assert_array_equal(got.numpy(), want)
    picks = x64(lambda: np.asarray(jax_pointops.furthest_point_sample(jnp.asarray(kept.numpy()), out)))
    np.testing.assert_array_equal(ops.furthest_point_sample(kept, out).numpy(), picks)
    with pytest.raises(ValueError, match="points a cloud"):
        sampling.train_random_crop(torch.from_numpy(gt), N * 2, out)


@pytest.mark.parametrize("epoch", [0, 50, 150])
def test_random_dropping_matches_jax(epoch):
    """The kept count's range at each epoch (768, 384 and 192 picks), JAX's
    draw handed over, the output equal on a 2048-point cloud (the KITTI
    finetune's size) and on one of 500 (FPS over all of it)."""
    rng = np.random.default_rng(epoch)
    key = jax.random.PRNGKey(epoch + 1)
    lo, hi = sampling.dropping_keep_range(epoch)
    assert (lo, hi) == (1, max(64, 768 // (epoch // 50 + 1)))
    for n in (2048, 500):
        pc = with_ties(rng, 2, n)

        def ref():
            keep_n = jax.random.randint(key, (), lo, hi)
            return (np.asarray(jax_sampling.random_dropping(key, jnp.asarray(pc), epoch)), int(keep_n))

        want, keep_n = x64(ref)
        got = sampling.random_dropping(torch.from_numpy(pc), epoch, keep_n=torch.tensor(keep_n))
        assert got.shape == (2, n, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[:, keep_n:] == 0).all() and (got[:, :keep_n] != 0).any()


def test_random_sample_and_scale_match_jax():
    rng = np.random.default_rng(12)
    data = rng.standard_normal((2, 300, 3))
    key = jax.random.PRNGKey(13)

    def ref():
        scores = jax.random.uniform(key, (2, 300))
        scale = jax.random.uniform(key, (), minval=0.8, maxval=1.2, dtype=jnp.float64)
        part, gt = jax_sampling.random_scale(key, jnp.asarray(data), jnp.asarray(data[:, :10]))
        return [np.array(a) for a in (jax_sampling.random_sample(key, jnp.asarray(data), 40), scores,
                                        scale, part, gt)]

    want, scores, scale, part, gt = x64(ref)
    got = sampling.random_sample(torch.from_numpy(data), 40, scores=torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), want)
    got_p, got_g = sampling.random_scale(torch.from_numpy(data), torch.from_numpy(data[:, :10]),
                                         scale=torch.tensor(float(scale), dtype=torch.float64))
    np.testing.assert_array_equal(got_p.numpy(), part)
    np.testing.assert_array_equal(got_g.numpy(), gt)
    g = torch.Generator().manual_seed(0)
    drawn_p, _ = sampling.random_scale(torch.from_numpy(data), torch.from_numpy(data), generator=g)
    ratio = (drawn_p / torch.from_numpy(data))[torch.from_numpy(data).abs() > 1e-3]
    assert 0.8 <= float(ratio.min()) <= float(ratio.max()) <= 1.2
