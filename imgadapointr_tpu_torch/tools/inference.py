"""Single-cloud inference CLI, the port's serving entry point.

Usage:
    python -m imgadapointr_tpu_torch.tools.inference \\
        --model_config cfgs/PCN_models/AdaPoinTr.yaml \\
        --model_checkpoint ckpt-best.pth \\
        --pc partial.npy --out_pc_root out/ [--device cuda]

Flags follow ``imgadapointr_tpu/tools/inference.py:25-36`` plus
``--device`` (default ``cuda``; the CPU runs only when asked for). The
checkpoint is a reference-layout torch state dict (``.pth``/``.pt``),
which the port's parameter names load with a plain ``load_state_dict``.
Clouds are ``.npy`` files; each is upsampled to 2048 points and its
completion written to ``<out_pc_root>/<name>/fine.npy``. Other cloud
formats, ``--save_vis_img`` and the JAX ``.ckpt`` format wait for a later
slice (ROADMAP Queue 1: the serving CLI's other inputs).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..datasets.transforms import UpSamplePoints
from ..models import build_model
from ..utils.config import cfg_from_yaml_file
from .convert import load_reference_state


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_config", required=True)
    parser.add_argument("--model_checkpoint", required=True)
    parser.add_argument("--pc_root", type=str, default="", help="dir of input clouds")
    parser.add_argument("--pc", type=str, default="", help="single input cloud")
    parser.add_argument("--out_pc_root", type=str, default="", help="output dir")
    parser.add_argument("--save_vis_img", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.save_vis_img:
        parser.error("--save_vis_img is not ported yet (ROADMAP Queue 1: the serving CLI's other inputs)")
    if not args.out_pc_root:
        parser.error("--out_pc_root is required")
    if not (args.pc or args.pc_root):
        parser.error("one of --pc / --pc_root is required")
    if not args.model_checkpoint.endswith((".pth", ".pt")):
        parser.error("--model_checkpoint: only reference torch .pth/.pt checkpoints load here")
    return args


def build(args):
    config = cfg_from_yaml_file(args.model_config)
    model = build_model(config.model, device=args.device)
    if model.inputs != ("partial",):  # as in the JAX package, clouds only
        raise ValueError(f"{config.model.NAME} takes {model.inputs}: this CLI reads point clouds only")
    model.load_state_dict(load_reference_state(args.model_checkpoint), strict=True)
    return config, model


@torch.inference_mode()
def inference_single(model, pc_path: str, args, config, root: str | None = None) -> np.ndarray:
    pc_file = os.path.join(root, pc_path) if root else pc_path
    if not pc_file.endswith(".npy"):
        raise ValueError(f"{pc_file}: only .npy clouds are read here (ROADMAP Queue 1: the serving CLI's other inputs)")
    pc = np.load(pc_file).astype(np.float32)

    # ShapeNet-55/34 inputs are centred and scaled into the unit sphere
    centroid = np.zeros(3, np.float32)
    m = 1.0
    if config.dataset.train.get("NAME") == "ShapeNet":
        centroid = np.mean(pc, axis=0)
        pc = pc - centroid
        m = float(np.max(np.sqrt(np.sum(pc**2, axis=1))))
        pc = pc / m

    pc = UpSamplePoints({"n_points": 2048})(pc, np.random.default_rng(0))
    device = next(model.parameters()).device
    _, fine = model(torch.from_numpy(np.ascontiguousarray(pc[None])).to(device))
    dense = fine[0].cpu().numpy() * m + centroid

    rel = os.path.basename(pc_path) if os.path.isabs(pc_path) else pc_path
    target = os.path.join(args.out_pc_root, os.path.splitext(rel)[0])
    os.makedirs(target, exist_ok=True)
    np.save(os.path.join(target, "fine.npy"), dense)
    return dense


def main(argv=None):
    args = get_args(argv)
    config, model = build(args)
    if args.pc_root:
        for f in sorted(os.listdir(args.pc_root)):
            if f.endswith(".npy"):
                inference_single(model, f, args, config, root=args.pc_root)
                print(f"done: {f}")
    else:
        inference_single(model, args.pc, args, config)
        print(f"done: {args.pc}")


if __name__ == "__main__":
    main()
