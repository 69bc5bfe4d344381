"""Weights and optimizer state into the port: flax trees, optax AdamW
moments and reference torch checkpoints.

:func:`state_dict_from_flax` carries a flax tree (nested dicts of numpy
arrays) of AdaPoinTr, ImgAdaPoinTr, SegEncAdaPoinTr or the superset across
to the port's state dict. It keeps its own copy of the JAX package's
mapping (``imgadapointr_tpu/tools/convert_torch.py:123-318`` for the
AdaPoinTr core, ``:319-406`` and ``convert_gdanet`` for the fusion stacks,
the ResNet trunk and GDANet), inverted as ``export_adapointr_torch``
inverts it: a flax kernel (in, out) becomes a torch weight (out, in) (with
trailing 1-dims for the reference's 1x1 convolutions), ConcatDense parts
are stacked back by rows, the split q / k / v maps are packed into
``in_proj_*``, convolution kernels go from HWIO to OIHW, norms and BN
statistics copy across. Because the port's parameters carry the reference
names, the result loads with ``model.load_state_dict(sd, strict=True)``.

The options no shipped config sets map the same way: the ``pn`` grouper
(``grouper.embedding.{first,second}_conv``, the reference's
``PCNEncoder`` layout, from flax's ``grouper/embedding/{first,second}_*``),
the ``fold`` head (``decode_head.folding{1,2}``, from
``decode_head/folding{1,2}_*``), LayerScale (``ls{i}.gamma``) and the
'onebyone' blocks' extra norms (``norm3``, ``norm_q_2``, ``norm_v_2``).
:func:`module_state_from_flax` carries the flax tree of a standalone
module: a legacy block (``nn/legacy_blocks.py``),
``ImprovedDeformableLocalCrossAttention``, ``ResNet50Encoder`` (torchvision's
names, as ResNet18's) or ``ConvNextEncoder``.

The five baselines (FoldingNet, PCN, TopNet, SnowFlakeNet, GRNet) have no
reference converter in the JAX package (``converter_for`` raises at
``imgadapointr_tpu/tools/convert_torch.py:565``), so the port names their
parameters after the flax tree: the module at ``a.b`` holds the flax scope
``a/b`` (:func:`_baseline_mapping`). Dense kernels are transposed,
ConcatDense parts stacked, ``Conv3d`` kernels go from (kD, kH, kW, in, out)
to (out, in, kD, kH, kW), and a ``ConvTranspose3d`` kernel is flipped in
its three spatial axes and laid out (in, out, kD, kH, kW): flax's
``ConvTranspose`` does not flip its kernel, PyTorch's transposed
convolution (the gradient of a convolution) does. A reference ``.pth`` of a
baseline is not read, as in the JAX package.

:func:`optimizer_state_from_optax` carries the optimizer state of a JAX
train state (the restored ``opt_state`` of the JAX chain, AdamW, Adam or
SGD, under ``MultiSteps`` or not) across the same mapping into the
``state_dict()`` of the port's optimizer, so the port can continue a JAX
run; :func:`adamw_state_from_optax` does it for Adam's moments
(``mu``, ``nu`` and the step ``count``); :func:`pending_grads_from_optax`
turns a ``MultiSteps`` state's pending running mean into the port's
pending gradient sum.

:func:`load_reference_state` reads a reference-layout ``.pth``/``.pt``;
:func:`load_weights` loads a model's weights from such a file or from a
JAX ``.ckpt``; :func:`load_gdanet_weights` loads a reference GDANet
checkpoint into the port's GDANet (``--gdanet_w``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import BASELINES
from ..models.gdanet import BLOCKS as GDANET_BLOCKS
from ..nn.blocks import _parse_style
from ..nn.image_encoders import ResNet18Encoder, ResNet50Encoder
from ..nn.layers import BatchNorm, ConcatDense, LayerScale, Linear
from ..utils.checkpoint import load_jax_checkpoint, resolve_jax_checkpoint

# models whose flax tree keeps the AdaPoinTr core under ``core`` beside
# their image encoder and / or GDANet (imgadapointr_tpu/models/*_adapointr.py)
BRANCH_MODELS = {  # name: (image branch, segmentation branch)
    "ImgResNetEncAdaPoinTrVariableLoss": (True, False),
    "SegEncAdaPoinTr": (False, True),
    "ImgEncSegDecAdaPoinTrVariableLoss": (True, True),
}


def _baseline_mapping(config) -> list:
    """The mapping of :func:`_mapping` for a baseline, read off the port's
    module tree (built on the meta device: no memory, no draws): a module
    at ``a.b`` takes the flax scope ``a/b``; kinds 'linear', 'concat',
    'conv3d' and 'deconv3d' for its weights."""
    with torch.device("meta"):
        model = BASELINES[config.NAME](config)
    m: list = []
    for name, mod in model.named_modules():
        fp = tuple(name.split("."))
        if isinstance(mod, Linear):
            m.append((f"{name}.weight", "linear", fp + ("kernel",), 0))
        elif isinstance(mod, ConcatDense):
            parts = tuple(fp + (f"part{i}", "kernel") for i in range(len(mod.widths)))
            m.append((f"{name}.weight", "concat", parts, 0))
        elif isinstance(mod, torch.nn.Conv3d):
            m.append((f"{name}.weight", "conv3d", fp + ("kernel",), 0))
        elif isinstance(mod, torch.nn.ConvTranspose3d):
            m.append((f"{name}.weight", "deconv3d", fp + ("kernel",), 0))
        elif isinstance(mod, BatchNorm):
            m.append((f"{name}.weight", "param", fp + ("scale",), 0))
            m.append((f"{name}.bias", "param", fp + ("bias",), 0))
            m.append((f"{name}.running_mean", "stats", fp + ("mean",), 0))
            m.append((f"{name}.running_var", "stats", fp + ("var",), 0))
            m.append((f"{name}.num_batches_tracked", "counter", (), 0))
            continue
        else:
            continue
        if getattr(mod, "bias", None) is not None:
            m.append((f"{name}.bias", "param", fp + (("part0", "bias") if isinstance(mod, ConcatDense)
                                                     else ("bias",)), 0))
    return m


def _mapping(config) -> list:
    """[(torch key, kind, flax path or paths, kernel dims)] for the AdaPoinTr
    tree with any block tokens and the fc head, and for the image
    and segmentation models built on it (:data:`BRANCH_MODELS`). kind:
    'linear' (kernel, transposed), 'concat' (ConcatDense parts stacked),
    'stack' (several kernels, each transposed, stacked by rows: a packed
    ``in_proj_weight``), 'cat' (several vectors joined), 'conv' (HWIO ->
    OIHW), 'param', 'stats' (BatchNorm running statistics), 'counter'
    (BatchNorm's ``num_batches_tracked``, which flax does not keep)."""
    if config.get("NAME") in BASELINES:
        return _baseline_mapping(config)
    m: list = []
    img, seg = BRANCH_MODELS.get(config.get("NAME"), (False, False))
    core = ("core",) if config.get("NAME") in BRANCH_MODELS else ()

    def linear(tk, fp, bias=True, kernel_dims=0):
        m.append((f"{tk}.weight", "linear", fp + ("kernel",), kernel_dims))
        if bias:
            m.append((f"{tk}.bias", "param", fp + ("bias",), 0))

    def norm(tk, fp):
        m.append((f"{tk}.weight", "param", fp + ("scale",), 0))
        m.append((f"{tk}.bias", "param", fp + ("bias",), 0))

    def concat(tk, fp, n_parts, kernel_dims=0):
        parts = tuple(fp + (f"part{i}", "kernel") for i in range(n_parts))
        m.append((f"{tk}.weight", "concat", parts, kernel_dims))
        m.append((f"{tk}.bias", "param", fp + ("part0", "bias"), 0))

    def batchnorm(tk, fp):
        norm(tk, fp)
        m.append((f"{tk}.running_mean", "stats", fp + ("mean",), 0))
        m.append((f"{tk}.running_var", "stats", fp + ("var",), 0))
        m.append((f"{tk}.num_batches_tracked", "counter", (), 0))

    bm = core + ("base_model",)
    enc, dec = config.encoder_config, config.decoder_config
    if config.encoder_type == "pn":  # SimpleEncoder's PCNEncoder
        tp, fp = "base_model.grouper.embedding", bm + ("grouper", "embedding")
        linear(f"{tp}.first_conv.0", fp + ("first_conv1",), kernel_dims=1)
        batchnorm(f"{tp}.first_conv.1", fp + ("first_bn",))
        linear(f"{tp}.first_conv.3", fp + ("first_conv2",), kernel_dims=1)
        concat(f"{tp}.second_conv.0", fp + ("second_conv1",), 2, kernel_dims=1)
        batchnorm(f"{tp}.second_conv.1", fp + ("second_bn",))
        linear(f"{tp}.second_conv.3", fp + ("second_conv2",), kernel_dims=1)
    else:
        linear("base_model.grouper.input_trans", bm + ("grouper", "input_trans"), kernel_dims=1)
        for i in range(1, 5):
            linear(f"base_model.grouper.layer{i}.0", bm + ("grouper", f"layer{i}_conv"),
                   bias=False, kernel_dims=2)
            norm(f"base_model.grouper.layer{i}.1", bm + ("grouper", f"layer{i}_gn"))
    for tk, (a, b) in (
        ("pos_embed", ("pos_embed1", "pos_embed2")),
        ("input_proj", ("input_proj1", "input_proj2")),
        ("increase_dim", ("increase_dim1", "increase_dim2")),
        ("coarse_pred", ("coarse_pred1", "coarse_pred2")),
    ):
        linear(f"base_model.{tk}.0", bm + (a,))
        linear(f"base_model.{tk}.2", bm + (b,))
    concat("base_model.mlp_query.0", bm + ("mlp_query1",), 2)
    linear("base_model.mlp_query.2", bm + ("mlp_query2",))
    linear("base_model.mlp_query.4", bm + ("mlp_query3",))
    for i, n in ((0, "query_ranking1"), (2, "query_ranking2"), (4, "query_ranking3")):
        linear(f"base_model.query_ranking.{i}", bm + (n,))
    if int(dec.embed_dim) != int(enc.embed_dim):
        linear("base_model.mem_link", bm + ("mem_link",))

    qkv_bias = bool(enc.get("qkv_bias", True))

    def local(tp, fp, token):
        """A local block token's parameters (convert_torch.py:236-255); the
        'deform_graph' module's ``proj_v_off`` always has a bias."""
        if token == "graph":
            linear(f"{tp}.knn_map.0", fp + ("knn_map",))
            return
        for mname in ("proj_q", "proj_k", "proj_v", "proj_v_off"):
            if token != "deform_graph" or mname == "proj_v_off":
                linear(f"{tp}.{mname}", fp + (mname,), bias=qkv_bias or token == "deform_graph")
        linear(f"{tp}.linear_offset.0", fp + ("linear_offset", "Dense_0"))
        norm(f"{tp}.linear_offset.1", fp + ("linear_offset", "LayerNorm_0"))
        linear(f"{tp}.linear_offset.3", fp + ("linear_offset", "Dense_1"), bias=False)
        linear(f"{tp}.knn_map.0" if token == "deform_graph" else f"{tp}.proj",
               fp + ("knn_map" if token == "deform_graph" else "proj",))

    def layer_scales(tp, fp, cfg, ids):
        if cfg.get("init_values", None):
            for j in ids:
                m.append((f"{tp}.ls{j}.gamma", "param", fp + (f"ls{j}", "gamma"), 0))

    for i, style in enumerate(enc.block_style_list):
        tp, fp = f"base_model.encoder.blocks.blocks.{i}", bm + ("encoder", f"block{i}")
        has_attn, loc = _parse_style(style)
        onebyone = has_attn and loc and enc.get("combine_style", "concat") == "onebyone"
        norm(f"{tp}.norm1", fp + ("norm1",))
        norm(f"{tp}.norm2", fp + ("norm2",))
        if onebyone:
            norm(f"{tp}.norm3", fp + ("norm3",))
        if has_attn:
            linear(f"{tp}.attn.qkv", fp + ("attn", "qkv"), bias=qkv_bias)
            linear(f"{tp}.attn.proj", fp + ("attn", "proj"))
        if loc:
            local(f"{tp}.local_attn", fp + ("local_attn",), loc)
            if has_attn and not onebyone:
                linear(f"{tp}.merge_map", fp + ("merge_map",))
        linear(f"{tp}.mlp.fc1", fp + ("mlp", "fc1"))
        linear(f"{tp}.mlp.fc2", fp + ("mlp", "fc2"))
        layer_scales(tp, fp, enc, (1, 2, 3) if onebyone else (1, 2))

    for i, (sa, ca) in enumerate(zip(dec.self_attn_block_style_list,
                                     dec.cross_attn_block_style_list)):
        tp, fp = f"base_model.decoder.blocks.blocks.{i}", bm + ("decoder", f"block{i}")
        for n in ("norm1", "norm2", "norm_q", "norm_v"):
            norm(f"{tp}.{n}", fp + (n,))
        sa_attn, sa_loc = _parse_style(sa)
        ca_attn, ca_loc = _parse_style(ca)
        sa_one = sa_attn and sa_loc and dec.get("self_attn_combine_style", "concat") == "onebyone"
        ca_one = ca_attn and ca_loc and dec.get("cross_attn_combine_style", "concat") == "onebyone"
        if sa_one:
            norm(f"{tp}.norm3", fp + ("norm3",))
        if ca_one:
            norm(f"{tp}.norm_q_2", fp + ("norm_q_2",))
            norm(f"{tp}.norm_v_2", fp + ("norm_v_2",))
        if sa_attn:
            linear(f"{tp}.self_attn.qkv", fp + ("self_attn", "qkv"), bias=qkv_bias)
            linear(f"{tp}.self_attn.proj", fp + ("self_attn", "proj"))
        if sa_loc:
            local(f"{tp}.local_self_attn", fp + ("local_self_attn",), sa_loc)
            if sa_attn and not sa_one:
                linear(f"{tp}.self_attn_merge_map", fp + ("self_attn_merge_map",))
        if ca_attn:
            for mname in ("q_map", "k_map", "v_map"):
                linear(f"{tp}.cross_attn.{mname}", fp + ("cross_attn", mname), bias=qkv_bias)
            linear(f"{tp}.cross_attn.proj", fp + ("cross_attn", "proj"))
        if ca_loc:
            local(f"{tp}.local_cross_attn", fp + ("local_cross_attn",), ca_loc)
            if ca_attn and not ca_one:
                linear(f"{tp}.cross_attn_merge_map", fp + ("cross_attn_merge_map",))
        linear(f"{tp}.mlp.fc1", fp + ("mlp", "fc1"))
        linear(f"{tp}.mlp.fc2", fp + ("mlp", "fc2"))
        layer_scales(tp, fp, dec, (1,) + ((3,) if sa_one else ()) + (4,) + ((5,) if ca_one else ()) + (2,))

    linear("increase_dim.0", core + ("increase_dim1",), kernel_dims=1)
    batchnorm("increase_dim.1", core + ("increase_dim_bn",))
    linear("increase_dim.3", core + ("increase_dim2",), kernel_dims=1)
    concat("reduce_map", core + ("reduce_map",), 3)
    if config.decoder_type == "fold":  # conv, BN, ReLU, conv, BN, ReLU, conv per fold
        for j in (1, 2):
            tp, fp = f"decode_head.folding{j}", core + ("decode_head",)
            concat(f"{tp}.0", fp + (f"folding{j}_conv1",), 2, kernel_dims=1)
            batchnorm(f"{tp}.1", fp + (f"folding{j}_bn1",))
            linear(f"{tp}.3", fp + (f"folding{j}_conv2",), kernel_dims=1)
            batchnorm(f"{tp}.4", fp + (f"folding{j}_bn2",))
            linear(f"{tp}.6", fp + (f"folding{j}_conv3",), kernel_dims=1)
    else:
        concat("decode_head.layer.fc1", core + ("decode_head", "layer_fc1"), 2)
        linear("decode_head.layer.fc2", core + ("decode_head", "layer_fc2"))

    def fusion(tag, fp):
        """get_better_{tag}_size + 5 attention layers + 5 LayerNorms
        (imgadapointr_tpu/tools/convert_torch.py:319-366, inverted)."""
        linear(f"base_model.get_better_{tag}_size.0", fp + ("proj",))
        fp = fp + ("fusion",)
        for i in (1, 2, 3):
            tk, cp = f"base_model.cross_attn_{tag}{i}", fp + (f"cross{i}",)
            maps = ("q_map", "k_map", "v_map")
            m.append((f"{tk}.in_proj_weight", "stack", tuple(cp + (n, "kernel") for n in maps), 0))
            m.append((f"{tk}.in_proj_bias", "cat", tuple(cp + (n, "bias") for n in maps), 0))
            linear(f"{tk}.out_proj", cp + ("proj",))
        for i in (1, 2):
            tk, sp = f"base_model.self_attn_{tag}{i}", fp + (f"self{i}",)
            m.append((f"{tk}.in_proj_weight", "linear", sp + ("qkv", "kernel"), 0))
            m.append((f"{tk}.in_proj_bias", "param", sp + ("qkv", "bias"), 0))
            linear(f"{tk}.out_proj", sp + ("proj",))
        for i in range(1, 6):
            norm(f"base_model.layer_norm_{tag}{i}", fp + (f"ln{i}",))

    if img and not config.get("img_before_dec", False):
        fusion("img", bm + ("img_fusion",))
    if seg:
        fusion("seg", bm + ("seg_fusion",))
    if img:  # torchvision's ResNet18 through layer3 (convert_torch.py:369-406)
        m += _resnet_mapping(ResNet18Encoder, "base_model.im_encoder.base", ("im_encoder", "trunk"))
    if seg:  # GDANet (convert_torch.py:convert_gdanet, inverted)
        tp, fp = "base_model.segmentator", ("segmentator",)
        for conv, bn, _, _ in GDANET_BLOCKS:
            linear(f"{tp}.{conv}.0", fp + (f"{conv}_conv",))
            batchnorm(f"{tp}.{bn}", fp + (f"{conv}_bn",))
        linear(f"{tp}.conv8", fp + ("conv8",))
        for sg in ("SGCAM_1s", "SGCAM_1g", "SGCAM_2s", "SGCAM_2g"):
            for n in ("g", "theta", "phi"):
                linear(f"{tp}.{sg}.{n}", fp + (sg, n))
            linear(f"{tp}.{sg}.W.0", fp + (sg, "W_conv"))
            m.append((f"{tp}.{sg}.W.1.weight", "param", fp + (sg, "W_bn_scale"), 0))
            m.append((f"{tp}.{sg}.W.1.bias", "param", fp + (sg, "W_bn_bias"), 0))
            m.append((f"{tp}.{sg}.W.1.running_mean", "stats", fp + (sg, "W_bn_mean"), 0))
            m.append((f"{tp}.{sg}.W.1.running_var", "stats", fp + (sg, "W_bn_var"), 0))
            m.append((f"{tp}.{sg}.W.1.num_batches_tracked", "counter", (), 0))
    return m


def _batchnorm_entries(tk: str, fp: tuple) -> list:
    return [(f"{tk}.weight", "param", fp + ("scale",), 0), (f"{tk}.bias", "param", fp + ("bias",), 0),
            (f"{tk}.running_mean", "stats", fp + ("mean",), 0),
            (f"{tk}.running_var", "stats", fp + ("var",), 0),
            (f"{tk}.num_batches_tracked", "counter", (), 0)]


def _resnet_mapping(encoder: type, tp: str, fp: tuple) -> list:
    """A torchvision-named ResNet trunk ``tp`` (``.0`` stem conv, ``.1``
    stem BN, ``.4``... the stages; ``conv{i}``, ``bn{i}``,
    ``downsample.{0,1}`` in a block) from the flax trunk ``fp``
    (``stem_conv``, ``stem_bn``, ``layer{s}_{b}/{conv,bn}{i}``,
    ``down_conv``, ``down_bn``). ResNet18 keeps three stages of two basic
    blocks, ResNet50 four bottleneck stages (3, 4, 6, 3)."""
    stages, n_conv = ((2, 2, 2), 2) if encoder is ResNet18Encoder else ((3, 4, 6, 3), 3)
    m = [(f"{tp}.0.weight", "conv", fp + ("stem_conv", "kernel"), 0)]
    m += _batchnorm_entries(f"{tp}.1", fp + ("stem_bn",))
    for s, blocks in enumerate(stages):
        for b in range(blocks):
            tb, fb = f"{tp}.{4 + s}.{b}", fp + (f"layer{s + 1}_{b}",)
            for i in range(1, n_conv + 1):
                m.append((f"{tb}.conv{i}.weight", "conv", fb + (f"conv{i}", "kernel"), 0))
                m += _batchnorm_entries(f"{tb}.bn{i}", fb + (f"bn{i}",))
            if b == 0 and (s > 0 or n_conv == 3):  # the shape changes: a projected shortcut
                m.append((f"{tb}.downsample.0.weight", "conv", fb + ("down_conv", "kernel"), 0))
                m += _batchnorm_entries(f"{tb}.downsample.1", fb + ("down_bn",))
    return m


# the local attention modules' Sequentials, as the flax tree names their layers
_FLAX_SUBNAMES = {("linear_offset", "0"): "Dense_0", ("linear_offset", "1"): "LayerNorm_0",
                  ("linear_offset", "3"): "Dense_1", ("knn_map", "0"): None}


def _flax_path(name: str) -> tuple:
    """The flax scope of the port's submodule ``name`` in a module named
    after the flax tree: ``a.b`` -> ``a/b``, with the local attention
    modules' Sequential indices renamed (``linear_offset.0`` ->
    ``linear_offset/Dense_0``, ``knn_map.0`` -> ``knn_map``)."""
    parts = name.split(".") if name else []
    out = []
    for i, p in enumerate(parts):
        key = (parts[i - 1], p) if i else None
        if key in _FLAX_SUBNAMES:
            if _FLAX_SUBNAMES[key] is not None:
                out.append(_FLAX_SUBNAMES[key])
        else:
            out.append(p)
    return tuple(out)


def _module_mapping(module: torch.nn.Module) -> list:
    """:func:`_mapping`'s entries for a standalone module whose names follow
    its flax tree (a legacy block, ``ImprovedDeformableLocalCrossAttention``,
    ``ConvNextEncoder``), or ResNet50's torchvision names."""
    if isinstance(module, ResNet50Encoder):
        return _resnet_mapping(ResNet50Encoder, "base", ("trunk",))
    m = []
    for name, mod in module.named_modules():
        fp, pre = _flax_path(name), f"{name}." if name else ""
        if isinstance(mod, Linear):
            m.append((f"{pre}weight", "linear", fp + ("kernel",), mod.weight.dim() - 2))
        elif isinstance(mod, torch.nn.Conv2d):
            m.append((f"{pre}weight", "conv", fp + ("kernel",), 0))
        elif isinstance(mod, torch.nn.LayerNorm):
            m.append((f"{pre}weight", "param", fp + ("scale",), 0))
        elif isinstance(mod, LayerScale):
            m.append((f"{pre}gamma", "param", fp + ("gamma",), 0))
            continue
        elif isinstance(mod, (BatchNorm, torch.nn.BatchNorm2d)):
            m += _batchnorm_entries(name, fp)
            continue
        else:
            if "gamma" in dict(mod.named_parameters(recurse=False)):  # a ConvNeXt block's
                m.append((f"{pre}gamma", "param", fp + ("gamma",), 0))
            continue
        if getattr(mod, "bias", None) is not None:
            m.append((f"{pre}bias", "param", fp + ("bias",), 0))
    return m


def module_state_from_flax(module: torch.nn.Module, params, batch_stats=None,
                           dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The state dict of a standalone ``module`` (see :func:`_module_mapping`)
    from its flax ``params`` / ``batch_stats``, for a strict
    ``load_state_dict``."""
    out = {}
    for tkey, kind, path, kernel_dims in _module_mapping(module):
        if kind == "stats":
            v = _leaf(batch_stats, path)
        elif kind == "counter":
            out[tkey] = torch.tensor(0, dtype=torch.int64)
            continue
        else:
            v = _convert_leaf(params, kind, path, kernel_dims)
        out[tkey] = torch.from_numpy(np.array(v)).to(dtype)
    return out


def conv3d_weight(kernel: np.ndarray) -> np.ndarray:
    """A flax ``Conv`` kernel (kD, kH, kW, in, out) as a ``Conv3d`` weight
    (out, in, kD, kH, kW); both cross-correlate."""
    return np.transpose(kernel, (4, 3, 0, 1, 2))


def conv_transpose3d_weight(kernel: np.ndarray) -> np.ndarray:
    """A flax ``ConvTranspose`` kernel (kD, kH, kW, in, out), which slides
    unflipped over the dilated input, as a ``ConvTranspose3d`` weight (in,
    out, kD, kH, kW), which the transposed convolution flips: flipped in
    the three spatial axes. With k 4 and stride 2, flax's 'SAME' padding (2
    on each side of the dilated input) is PyTorch's ``padding=1``."""
    return np.transpose(kernel[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _params_from_flax(params, config) -> dict[str, np.ndarray]:
    """A flax params-shaped tree (weights, gradients or moments) -> arrays
    under the port's parameter names, in the port's layouts."""
    return {tkey: _convert_leaf(params, kind, path, kernel_dims)
            for tkey, kind, path, kernel_dims in _mapping(config)
            if kind not in ("stats", "counter")}


def _convert_leaf(params, kind: str, path, kernel_dims: int) -> np.ndarray:
    """One mapping entry's array in the port's layout."""
    if kind == "linear":
        w = _leaf(params, path).T
        return w.reshape(w.shape + (1,) * kernel_dims)
    if kind == "concat":
        w = np.concatenate([_leaf(params, p) for p in path], axis=0).T
        return w.reshape(w.shape + (1,) * kernel_dims)
    if kind == "stack":
        return np.concatenate([_leaf(params, p).T for p in path], axis=0)
    if kind == "cat":
        return np.concatenate([_leaf(params, p) for p in path], axis=0)
    if kind == "conv":
        return np.transpose(_leaf(params, path), (3, 2, 0, 1))
    if kind == "conv3d":
        return conv3d_weight(_leaf(params, path))
    if kind == "deconv3d":
        return conv_transpose3d_weight(_leaf(params, path))
    if kind == "param":
        return _leaf(params, path)
    raise ValueError(f"unknown mapping kind {kind!r}")


def state_dict_from_flax(params, batch_stats, config, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """flax ``params`` / ``batch_stats`` (nested dicts of numpy arrays) of
    AdaPoinTr, a model of :data:`BRANCH_MODELS` or a baseline (``models.BASELINES``)
    (``config.NAME``) -> the port's state dict in ``dtype`` (float32 by
    default; reference key layout; the baselines' flax names)."""
    sd = _params_from_flax(params, config)
    out = {}
    for tkey, kind, path, _ in _mapping(config):
        if kind == "stats":
            sd[tkey] = _leaf(batch_stats, path)
        elif kind == "counter":
            out[tkey] = torch.tensor(0, dtype=torch.int64)
    if config.get("NAME") not in BASELINES:
        # the reference's encoder norm is defined but never applied
        # (base_blocks.py:429-431): exported as the identity
        dim = int(config.encoder_config.embed_dim)
        sd["base_model.encoder.norm.weight"] = np.ones(dim)
        sd["base_model.encoder.norm.bias"] = np.zeros(dim)
    out.update({k: torch.from_numpy(np.array(v)).to(dtype) for k, v in sd.items()})
    return out


def adamw_state_from_optax(mu, nu, count: int, config, model, optimizer) -> dict:
    """The JAX package's AdamW state as a ``torch.optim.AdamW.state_dict()``.

    ``mu`` / ``nu`` are optax's first and second moments
    (``ScaleByAdamState``), flax-params-shaped trees of numpy arrays, and
    ``count`` its number of updates. The result is for ``optimizer``, built
    over ``model``'s parameters (any grouping): load it with
    ``optimizer.load_state_dict``. Parameters without a gradient (the
    query-ranking subtree, which optax tracks with zero moments, and the
    unused encoder norm) get no state, as torch keeps none for them; the
    frozen GDANet of the segmentation models (``segmentator``, zero
    moments in optax) is in no parameter group of the port's AdamW and
    gets none either; nor do the deformable blocks' ``linear_offset`` and
    ``proj_v_off``, which get no gradient (``ZERO_GRAD_PARAM_MARKERS``)."""
    return _state_from_flax(optimizer, model, config, {"exp_avg": mu, "exp_avg_sq": nu}, step=count)


def _find_states(tree, keys: set) -> list:
    """The sub-dicts of a restored optax state whose keys are ``keys``."""
    if not isinstance(tree, dict):
        return []
    if set(tree) == keys:
        return [tree]
    return [found for v in tree.values() for found in _find_states(v, keys)]


def optimizer_state_from_optax(opt_state, config, model, optimizer) -> dict:
    """The ``state_dict()`` of ``optimizer`` (the port's AdamW, Adam or SGD
    over ``model``) from ``opt_state``, the JAX package's optimizer state
    restored from a checkpoint (flax's state-dict form: nested dicts, a
    tuple's entries under ``"0"``, ``"1"``, ...).

    The JAX chain is ``masked(set_to_zero)`` (frozen subtrees only), then
    the clip, then AdamW, Adam or SGD, all under ``MultiSteps`` when
    ``step_per_update`` > 1 (``imgadapointr_tpu/tools/builder.py:140-190``).
    Adam and AdamW keep their moments in the one ``ScaleByAdamState``
    (``count``, ``mu``, ``nu``), SGD with momentum its ``TraceState``
    (``trace``: torch's ``momentum_buffer``, the same recursion ``b = m b +
    g``); SGD without momentum keeps none. The state of ``MultiSteps`` is
    ``inner_opt_state``; its pending gradients are
    :func:`pending_grads_from_optax`'s."""
    inner = opt_state.get("inner_opt_state", opt_state) if isinstance(opt_state, dict) else opt_state
    if isinstance(optimizer, torch.optim.SGD):
        traces = _find_states(inner, {"trace"})
        if not optimizer.defaults["momentum"]:
            if traces:
                raise ValueError("the JAX state holds a momentum trace; the port's SGD has no momentum")
            return {"state": {}, "param_groups": optimizer.state_dict()["param_groups"]}
        if len(traces) != 1:
            raise ValueError(f"expected one momentum trace in the JAX SGD state, found {len(traces)}")
        return _state_from_flax(optimizer, model, config, {"momentum_buffer": traces[0]["trace"]})
    adams = _find_states(inner, {"count", "mu", "nu"})
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)) or len(adams) != 1:
        raise ValueError(f"{type(optimizer).__name__}: expected one Adam state in the JAX state, "
                         f"found {len(adams)}")
    (adam,) = adams
    return adamw_state_from_optax(adam["mu"], adam["nu"], int(adam["count"]), config, model, optimizer)


def pending_grads_from_optax(opt_state, config, model) -> dict:
    """The gradient sum pending in a JAX ``MultiSteps`` state, by the port's
    parameter names, as tensors on the parameters' device and dtype: empty
    unless ``mini_step`` m > 0. optax keeps the running mean of the m
    gradients so far (``acc_grads``, ``acc + (g - acc) / (n + 1)``), and
    the JAX chain scales the mean of all k by k in front of the inner chain
    (``imgadapointr_tpu/tools/builder.py:179-190``), which is the sum the
    port's runner adds up in ``grad``: so the pending sum is m *
    ``acc_grads``. Parameters that get no gradient (see
    :func:`adamw_state_from_optax`) get none here either."""
    from .builder import ZERO_GRAD_PARAM_MARKERS

    if not isinstance(opt_state, dict) or int(opt_state.get("mini_step", 0)) == 0:
        return {}
    m = int(opt_state["mini_step"])
    arrays = _params_from_flax(opt_state["acc_grads"], config)
    return {name: (m * torch.from_numpy(np.array(arrays[name])).to(torch.float64)).to(p)
            for name, p in model.named_parameters()
            if p.requires_grad and name in arrays and not any(k in name for k in ZERO_GRAD_PARAM_MARKERS)}


def _state_from_flax(optimizer, model, config, trees: dict, step: int | None = None) -> dict:
    """``optimizer.state_dict()`` with each entry of ``trees`` (a flax
    params-shaped tree per state name) under the port's parameter names.
    Parameters without a gradient get no state (see
    :func:`adamw_state_from_optax`)."""
    from .builder import ZERO_GRAD_PARAM_MARKERS

    arrays = {key: _params_from_flax(tree, config) for key, tree in trees.items()}
    names = {id(p): n for n, p in model.named_parameters()}
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            if (p.requires_grad and all(name in a for a in arrays.values())
                    and not any(m in name for m in ZERO_GRAD_PARAM_MARKERS)):
                state[index] = {} if step is None else {"step": torch.tensor(float(step))}
                state[index].update({key: torch.from_numpy(np.array(a[name])).to(p)
                                     for key, a in arrays.items()})
            index += 1
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def _fit_gdanet(src: dict, own: dict) -> dict:
    """The entries of ``src`` (a reference GDANet state dict) that the
    port's GDANet, whose state dict is ``own``, takes: a pointwise weight
    may come as ``(out, in)`` or with the trailing 1-dims of the
    reference's Conv1d / Conv2d. Raises on any other shape."""
    taken = {}
    for key, want in own.items():
        if key not in src:
            continue
        v = src[key]
        if tuple(v.shape[:want.dim()]) != tuple(want.shape) or any(d != 1 for d in v.shape[want.dim():]):
            raise ValueError(f"GDANet {key}: shape {tuple(v.shape)}, the port takes {tuple(want.shape)}")
        taken[key] = v.reshape(want.shape).to(want.dtype)
    return taken


def load_gdanet_weights(path: str, gdanet: torch.nn.Module) -> list[str]:
    """``--gdanet_w``: a reference GDANet part-segmentation checkpoint into
    ``gdanet`` (the port's ``models.gdanet.GDANet``); returns the keys of
    ``gdanet`` it did not fill.

    Like the reference's load (``strict=False``) every key of the port's
    GDANet that the checkpoint holds is taken (see :func:`_fit_gdanet`).
    Raises when nothing matches: a wrong file would otherwise leave a random
    frozen GDANet (``imgadapointr_tpu/tools/convert_torch.py:625-640``)."""
    src = load_reference_state(path)
    own = gdanet.state_dict()
    taken = _fit_gdanet(src, own)
    if not taken:
        raise ValueError(f"no GDANet weights matched in {path} (checkpoint keys: {list(src)[:5]}...)")
    gdanet.load_state_dict(taken, strict=False)
    return sorted(set(own) - set(taken))


def fit_reference_state(sd: dict, model: torch.nn.Module) -> dict:
    """A reference-layout state dict ``sd`` for ``model``: under a frozen
    GDANet (``base_model.segmentator``) the pointwise weights drop the
    reference's trailing 1-dims and the entries the port does not keep
    (the reference holds each BatchNorm twice, also under ``convN.1``) are
    left out; every other entry stays as it is, for a strict load."""
    gdanet = getattr(getattr(model, "base_model", None), "segmentator", None)
    if gdanet is None:
        return sd
    prefix = "base_model.segmentator."
    seg = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out = {k: v for k, v in sd.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in _fit_gdanet(seg, gdanet.state_dict()).items()})
    return out


def load_reference_state(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout torch checkpoint (``{'base_model': sd}``,
    ``{'model': sd}`` or a bare state dict, DDP ``module.`` prefixes
    allowed) as a plain state dict on the CPU."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "base_model", "state_dict", "model_state_dict", "net"):
        if isinstance(raw, dict) and key in raw:
            raw = raw[key]
            break
    return {k.removeprefix("module."): v for k, v in raw.items() if torch.is_tensor(v)}


def load_weights(model: torch.nn.Module, path: str, config, experiment_path: str | None = None) -> None:
    """Load ``model``'s weights (strictly) from ``path``: a reference-layout
    or port ``.pth`` / ``.pt`` (:func:`load_reference_state`,
    :func:`fit_reference_state`), else a JAX checkpoint, resolved as the
    JAX runner resolves ``--start_ckpts`` (a ``.ckpt`` path, a bare prefix,
    or either inside ``experiment_path``), whose ``params`` and
    ``batch_stats`` go through :func:`state_dict_from_flax` in the model's
    dtype. ``config`` is the model config."""
    if path.endswith((".pth", ".pt")):
        model.load_state_dict(fit_reference_state(load_reference_state(path), model), strict=True)
        return
    tree, _ = load_jax_checkpoint(resolve_jax_checkpoint(path, experiment_path))
    load_flax_weights(model, tree, config)


def load_flax_weights(model: torch.nn.Module, tree: dict, config) -> None:
    """``tree['params']`` and ``tree['batch_stats']`` (a JAX checkpoint's
    payload) into ``model``, strictly, in the model's dtype."""
    dtype = next(model.parameters()).dtype
    sd = state_dict_from_flax(tree["params"], tree.get("batch_stats") or {}, config, dtype=dtype)
    model.load_state_dict(sd, strict=True)
