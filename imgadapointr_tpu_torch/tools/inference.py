"""Single-cloud inference CLI, the port's serving entry point.

Usage:
    python -m imgadapointr_tpu_torch.tools.inference \\
        --model_config cfgs/PCN_models/AdaPoinTr.yaml \\
        --model_checkpoint ckpt-best.pth \\
        --pc partial.pcd --out_pc_root out/ [--save_vis_img] [--device cuda]

Flags follow ``imgadapointr_tpu/tools/inference.py:25-36`` plus
``--device`` (default ``cuda``; the CPU runs only when asked for). The
checkpoint is a reference-layout torch state dict (``.pth``/``.pt``, the
port's own checkpoints among them) or a JAX ``.ckpt``
(:func:`tools.convert.load_weights`). A cloud is any format ``IO.get``
reads; a ``--pc_root`` directory is read for ``.npy``, ``.pcd``, ``.ply``,
``.txt``, ``.xyz`` and ``.h5`` files. Each cloud is upsampled to 2048
points and its completion written to ``<out_pc_root>/<name>/fine.npy``,
with ``input.jpg`` and ``fine.jpg`` renders (``utils/render.py``, numpy
and PIL) under ``--save_vis_img``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..datasets.transforms import UpSamplePoints
from ..models import build_model
from ..utils.config import cfg_from_yaml_file
from ..utils.device import resolve_device
from ..utils import render
from ..utils.io_module import IO
from .convert import load_weights

CLOUD_EXTENSIONS = (".npy", ".pcd", ".ply", ".txt", ".xyz", ".h5")


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_config", required=True)
    parser.add_argument("--model_checkpoint", required=True, help=".pth / .pt, or a JAX .ckpt")
    parser.add_argument("--pc_root", type=str, default="", help="dir of input clouds")
    parser.add_argument("--pc", type=str, default="", help="single input cloud")
    parser.add_argument("--out_pc_root", type=str, default="", help="output dir")
    parser.add_argument("--save_vis_img", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if not (args.save_vis_img or args.out_pc_root):
        parser.error("one of --out_pc_root / --save_vis_img is required")
    if not (args.pc or args.pc_root):
        parser.error("one of --pc / --pc_root is required")
    return args


def build(args):
    config = cfg_from_yaml_file(args.model_config)
    model = build_model(config.model, device=resolve_device(args.device))
    if model.inputs != ("partial",):  # as in the JAX package, clouds only
        raise ValueError(f"{config.model.NAME} takes {model.inputs}: this CLI reads point clouds only "
                         "(PCReconstructor serves the image and segmentation models)")
    load_weights(model, args.model_checkpoint, config.model)
    return config, model


@torch.inference_mode()
def inference_single(model, pc_path: str, args, config, root: str | None = None) -> np.ndarray:
    pc_file = os.path.join(root, pc_path) if root else pc_path
    pc = IO.get(pc_file).astype(np.float32)

    # ShapeNet-55/34 inputs are centred and scaled into the unit sphere
    centroid = np.zeros(3, np.float32)
    m = 1.0
    if config.dataset.train.get("NAME") == "ShapeNet":
        centroid = np.mean(pc, axis=0)
        pc = pc - centroid
        m = float(np.max(np.sqrt(np.sum(pc**2, axis=1))))
        pc = pc / m

    pc = UpSamplePoints({"n_points": 2048})(pc, np.random.default_rng(0))
    model.eval()
    device = next(model.parameters()).device
    _, fine = model(torch.from_numpy(np.ascontiguousarray(pc[None])).to(device))
    dense = fine[0].cpu().numpy() * m + centroid

    if args.out_pc_root:
        rel = os.path.basename(pc_path) if os.path.isabs(pc_path) else pc_path
        target = os.path.join(args.out_pc_root, os.path.splitext(rel)[0])
        os.makedirs(target, exist_ok=True)
        np.save(os.path.join(target, "fine.npy"), dense)
        if args.save_vis_img:
            save_vis(target, pc, dense)
    return dense


def save_vis(target: str, partial: np.ndarray, dense: np.ndarray) -> None:
    """``input.jpg`` and ``fine.jpg``: the (upsampled) input and the
    completion as 3-D scatter plots (JAX ``tools/inference.py:107-118``),
    drawn by ``utils/render.py``."""
    for name, cloud in (("input", partial), ("fine", dense)):
        render.save_cloud(os.path.join(target, f"{name}.jpg"), cloud)


def main(argv=None):
    args = get_args(argv)
    config, model = build(args)
    if args.pc_root:
        for f in sorted(os.listdir(args.pc_root)):
            if os.path.splitext(f)[-1].lower() in CLOUD_EXTENSIONS:
                inference_single(model, f, args, config, root=args.pc_root)
                print(f"done: {f}")
    else:
        inference_single(model, args.pc, args, config)
        print(f"done: {args.pc}")


if __name__ == "__main__":
    main()
