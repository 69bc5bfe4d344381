"""Weights into the port: flax trees and reference torch checkpoints.

:func:`state_dict_from_flax` carries a flax AdaPoinTr tree (nested dicts of
numpy arrays) across to the port's state dict. It keeps its own copy of the
flagship part of the JAX package's mapping
(``imgadapointr_tpu/tools/convert_torch.py:123-318``), inverted as
``export_adapointr_torch`` inverts it: a flax kernel (in, out) becomes a
torch weight (out, in) (with trailing 1-dims for the reference's 1x1
convolutions), ConcatDense parts are stacked back by rows, norms and BN
statistics copy across. Because the port's parameters carry the reference
names, the result loads with ``model.load_state_dict(sd, strict=True)``.

:func:`load_reference_state` reads a reference-layout ``.pth``/``.pt``.
"""

from __future__ import annotations

import numpy as np
import torch


def _mapping(config) -> list:
    """[(torch key, kind, flax path or paths, kernel dims)] for the
    point-only AdaPoinTr tree with graph / attn block tokens and the fc
    head. kind: 'linear' | 'concat' | 'param' | 'stats'."""
    m: list = []

    def linear(tk, fp, bias=True, kernel_dims=0):
        m.append((f"{tk}.weight", "linear", fp + ("kernel",), kernel_dims))
        if bias:
            m.append((f"{tk}.bias", "param", fp + ("bias",), 0))

    def norm(tk, fp):
        m.append((f"{tk}.weight", "param", fp + ("scale",), 0))
        m.append((f"{tk}.bias", "param", fp + ("bias",), 0))

    def concat(tk, fp, n_parts):
        parts = tuple(fp + (f"part{i}", "kernel") for i in range(n_parts))
        m.append((f"{tk}.weight", "concat", parts, 0))
        m.append((f"{tk}.bias", "param", fp + ("part0", "bias"), 0))

    bm = ("base_model",)
    enc, dec = config.encoder_config, config.decoder_config
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

    def tokens(style):
        ts = style.split("-")
        for t in ts:
            if t not in ("attn", "graph"):
                raise NotImplementedError(f"block token {t!r} has no port yet")
        return "attn" in ts, "graph" in ts

    for i, style in enumerate(enc.block_style_list):
        tp, fp = f"base_model.encoder.blocks.blocks.{i}", bm + ("encoder", f"block{i}")
        has_attn, has_graph = tokens(style)
        norm(f"{tp}.norm1", fp + ("norm1",))
        norm(f"{tp}.norm2", fp + ("norm2",))
        if has_attn:
            linear(f"{tp}.attn.qkv", fp + ("attn", "qkv"), bias=qkv_bias)
            linear(f"{tp}.attn.proj", fp + ("attn", "proj"))
        if has_graph:
            linear(f"{tp}.local_attn.knn_map.0", fp + ("local_attn", "knn_map"))
            if has_attn:
                linear(f"{tp}.merge_map", fp + ("merge_map",))
        linear(f"{tp}.mlp.fc1", fp + ("mlp", "fc1"))
        linear(f"{tp}.mlp.fc2", fp + ("mlp", "fc2"))

    for i, (sa, ca) in enumerate(zip(dec.self_attn_block_style_list,
                                     dec.cross_attn_block_style_list)):
        tp, fp = f"base_model.decoder.blocks.blocks.{i}", bm + ("decoder", f"block{i}")
        for n in ("norm1", "norm2", "norm_q", "norm_v"):
            norm(f"{tp}.{n}", fp + (n,))
        sa_attn, sa_graph = tokens(sa)
        ca_attn, ca_graph = tokens(ca)
        if sa_attn:
            linear(f"{tp}.self_attn.qkv", fp + ("self_attn", "qkv"), bias=qkv_bias)
            linear(f"{tp}.self_attn.proj", fp + ("self_attn", "proj"))
        if sa_graph:
            linear(f"{tp}.local_self_attn.knn_map.0", fp + ("local_self_attn", "knn_map"))
            if sa_attn:
                linear(f"{tp}.self_attn_merge_map", fp + ("self_attn_merge_map",))
        if ca_attn:
            for mname in ("q_map", "k_map", "v_map"):
                linear(f"{tp}.cross_attn.{mname}", fp + ("cross_attn", mname), bias=qkv_bias)
            linear(f"{tp}.cross_attn.proj", fp + ("cross_attn", "proj"))
        if ca_graph:
            linear(f"{tp}.local_cross_attn.knn_map.0", fp + ("local_cross_attn", "knn_map"))
            if ca_attn:
                linear(f"{tp}.cross_attn_merge_map", fp + ("cross_attn_merge_map",))
        linear(f"{tp}.mlp.fc1", fp + ("mlp", "fc1"))
        linear(f"{tp}.mlp.fc2", fp + ("mlp", "fc2"))

    linear("increase_dim.0", ("increase_dim1",), kernel_dims=1)
    norm("increase_dim.1", ("increase_dim_bn",))
    m.append(("increase_dim.1.running_mean", "stats", ("increase_dim_bn", "mean"), 0))
    m.append(("increase_dim.1.running_var", "stats", ("increase_dim_bn", "var"), 0))
    linear("increase_dim.3", ("increase_dim2",), kernel_dims=1)
    concat("reduce_map", ("reduce_map",), 3)
    if config.decoder_type != "fc":
        raise NotImplementedError(f"decoder_type {config.decoder_type!r} has no port yet")
    concat("decode_head.layer.fc1", ("decode_head", "layer_fc1"), 2)
    linear("decode_head.layer.fc2", ("decode_head", "layer_fc2"))
    return m


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def state_dict_from_flax(params, batch_stats, config) -> dict[str, torch.Tensor]:
    """flax AdaPoinTr ``params`` / ``batch_stats`` (nested dicts of numpy
    arrays) -> the port's float32 state dict (reference key layout)."""
    sd: dict[str, np.ndarray] = {}
    for tkey, kind, path, kernel_dims in _mapping(config):
        if kind == "linear":
            w = _leaf(params, path).T
            w = w.reshape(w.shape + (1,) * kernel_dims)
        elif kind == "concat":
            w = np.concatenate([_leaf(params, p) for p in path], axis=0).T
        elif kind == "stats":
            w = _leaf(batch_stats, path)
        else:
            w = _leaf(params, path)
        sd[tkey] = w
    # the reference's encoder norm is defined but never applied
    # (base_blocks.py:429-431): exported as the identity
    dim = int(config.encoder_config.embed_dim)
    sd["base_model.encoder.norm.weight"] = np.ones(dim)
    sd["base_model.encoder.norm.bias"] = np.zeros(dim)
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    out["increase_dim.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
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
