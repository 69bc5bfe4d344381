"""The benchmark's data: the generators that make its inputs from a seed,
and the plain reader that works the training batches out again from disk.

Frozen copies, each from where it came:

- :func:`surface_points` and :func:`synthetic_sample`: the arithmetic of
  ``imgadapointr_tpu_torch/datasets/synthetic.py`` (``_surface_points``,
  ``SyntheticPCN.get``);
- :func:`write_pcn_tree`: ``chip_smoke.py:write_pcn_tree``, with the
  taxonomies and sizes as parameters and its own binary ``.pcd`` writer;
- :func:`read_pcd`, :func:`pcn_train_sample`, :func:`epoch_order`: the PCN
  train split as ``datasets/pcn_dataset.py``, ``datasets/transforms.py``
  and ``datasets/loader.py`` define it (the sample's generator
  ``default_rng((base_seed, i))``, one uniform drawn per transform, a
  random render, a permutation cut to 2048 points and zero-padded, the
  mirror by the second transform's uniform).
"""

from __future__ import annotations

import json
import os

import numpy as np

PCD_HEADER = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              "WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")


def surface_points(rng: np.random.Generator, n: int) -> np.ndarray:
    """A random smooth closed surface: deformed ellipsoid samples (n, 3)."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = np.arccos(rng.uniform(-1, 1, n))
    radii = rng.uniform(0.2, 0.5, 3)
    bumps = rng.uniform(0.0, 0.15, 3)
    freq = rng.integers(1, 4, 3)
    r = 1.0 + bumps[0] * np.sin(freq[0] * u) + bumps[1] * np.cos(freq[1] * v)
    pts = np.stack([radii[0] * r * np.sin(v) * np.cos(u), radii[1] * r * np.sin(v) * np.sin(u),
                    radii[2] * (r + bumps[2] * np.sin(freq[2] * u)) * np.cos(v)], axis=-1)
    return pts.astype(np.float32)


def synthetic_sample(seed: int, idx: int, n_gt: int, n_partial: int, with_img: bool, with_cls: bool) -> dict:
    """One PCN-shaped sample: the complete surface, a half-space crop of it
    with 0.005 jitter as the partial, a uniform image and a class one-hot."""
    srng = np.random.default_rng(seed * 100003 + idx)
    gt = surface_points(srng, n_gt)
    normal = srng.normal(size=3)
    normal /= np.linalg.norm(normal)
    vis = gt[gt @ normal > np.quantile(gt @ normal, 0.5)]
    partial = vis[srng.integers(0, len(vis), n_partial)] + srng.normal(0, 0.005, (n_partial, 3)).astype(np.float32)
    out = {"partial": partial.astype(np.float32), "gt": gt}
    if with_img:
        out["img"] = srng.uniform(0, 1, (224, 224, 3)).astype(np.float32)
    if with_cls:
        out["cls_vec"] = np.zeros(16, np.float32)
        out["cls_vec"][idx % 16] = 1
    return out


def write_pcd(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(PCD_HEADER.format(n=len(arr)).encode("ascii"))
        f.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())


def read_pcd(path: str) -> np.ndarray:
    """x, y, z of a binary PCD v0.7 of float32 x, y, z fields."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"DATA binary\n") + len(b"DATA binary\n")
    n = int(next(line.split()[1] for line in raw[:end].decode("ascii").splitlines() if line.startswith("POINTS")))
    return np.frombuffer(raw, dtype="<f4", count=3 * n, offset=end).reshape(n, 3).astype(np.float32)


def pcn_paths(root: str, layout: dict) -> dict:
    """The dataset paths of ``layout`` (a traffic file's ``dataset``) under ``root``."""
    return {k: os.path.join(root, layout[k]) for k in ("CATEGORY_FILE_PATH", "PARTIAL_POINTS_PATH",
                                                       "COMPLETE_POINTS_PATH")}


def write_pcn_tree(root: str, layout: dict, tree: dict, seed: int) -> list:
    """A PCN tree: ``tree["taxonomies"]`` train models each, ``renders``
    partials of ``partial_points`` = [lo, hi) points (one side of the
    surface, jittered) and a complete cloud of ``layout["N_POINTS"]``.
    Returns the category file's entries."""
    rng = np.random.default_rng(seed)
    paths = pcn_paths(root, layout)
    cats = [{"taxonomy_id": t, "taxonomy_name": t, "train": [f"{t}_m{i:03d}" for i in range(n)], "val": [], "test": []}
            for t, n in tree["taxonomies"].items()]
    os.makedirs(os.path.dirname(paths["CATEGORY_FILE_PATH"]), exist_ok=True)
    with open(paths["CATEGORY_FILE_PATH"], "w") as f:
        json.dump(cats, f)
    lo, hi = tree["partial_points"]
    for dc in cats:
        for m in dc["train"]:
            gt = surface_points(rng, int(layout["N_POINTS"]))
            normal = rng.standard_normal(3)
            side = gt[gt @ normal > np.median(gt @ normal)]
            for r in range(int(layout["N_RENDERINGS"])):
                pts = side[rng.integers(0, len(side), int(rng.integers(lo, hi)))]
                pts = pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)
                path = paths["PARTIAL_POINTS_PATH"] % ("train", dc["taxonomy_id"], m, r)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_pcd(path, pts)
            path = paths["COMPLETE_POINTS_PATH"] % ("train", dc["taxonomy_id"], m)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_pcd(path, gt)
    return cats


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(seed + epoch).permutation(n)


def base_seed(seed: int, epoch: int) -> int:
    return (seed * 7919 + epoch) & 0x7FFFFFFF


def pcn_train_sample(root: str, layout: dict, cats: list, i: int, base: int, n_points: int = 2048) -> dict:
    """Train sample ``i`` of the file list (taxonomies in file order, then
    models), its draws from ``default_rng((base, i))``."""
    files = [(dc["taxonomy_id"], m) for dc in cats for m in dc["train"]]
    tax, model = files[i]
    paths = pcn_paths(root, layout)
    rng = np.random.default_rng((base, i))
    r = int(rng.integers(0, int(layout["N_RENDERINGS"])))
    partial = read_pcd(paths["PARTIAL_POINTS_PATH"] % ("train", tax, model, r))
    gt = read_pcd(paths["COMPLETE_POINTS_PATH"] % ("train", tax, model))
    rng.uniform(0, 1)  # RandomSamplePoints' uniform, unused
    partial = partial[rng.permutation(partial.shape[0])[:n_points]]
    if partial.shape[0] < n_points:
        partial = np.concatenate([partial, np.zeros((n_points - partial.shape[0], 3), np.float32)])
    u = rng.uniform(0, 1)  # RandomMirrorPoints'
    mat = np.eye(3, dtype=np.float32)
    mx = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    mz = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    if u <= 0.25:
        mat = mx @ mz @ mat
    elif u <= 0.5:
        mat = mx @ mat
    elif u <= 0.75:
        mat = mz @ mat
    return {"partial": np.ascontiguousarray(partial @ mat.T, dtype=np.float32),
            "gt": np.ascontiguousarray(gt @ mat.T, dtype=np.float32)}


def pcn_train_batch(root: str, layout: dict, cats: list, seed: int, epoch: int, step: int, bs: int) -> dict:
    """Batch ``step`` of ``epoch`` of the shuffled train split, stacked."""
    n = sum(len(dc["train"]) for dc in cats)
    order = epoch_order(n, seed, epoch)[step * bs:(step + 1) * bs]
    base = base_seed(seed, epoch)
    samples = [pcn_train_sample(root, layout, cats, int(i), base) for i in order]
    return {k: np.stack([s[k] for s in samples]) for k in ("partial", "gt")}
