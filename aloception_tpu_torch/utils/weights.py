"""The named-weights registry, and JAX-package parameters -> this package's
``state_dict``.

``WEIGHT_REGISTRY``, ``resolve_weights`` and ``load_weights`` are the JAX
package's (``aloception_tpu/utils/weights.py``, after the reference's
``alonet/common/weights.py``): a name maps to a local file under
``WEIGHTS_DIR``, which the user fills with the published ``.pth`` files;
nothing is fetched. The port's models use the reference's key names, so a
published state dict loads into them as it is.

The converters are the exact inverses of the torch -> flax converters of
``aloception_tpu/utils/weights.py`` (``convert_resnet50_backbone``,
``convert_mha``, ``convert_detr_checkpoint``,
``convert_deformable_checkpoint``, ``convert_panoptic_checkpoint``,
``convert_raft_checkpoint``): each takes
flax params as
nested dicts of numpy arrays and returns float tensors under the reference
torch names, so a model of the JAX package can be loaded into its port with
``load_state_dict(strict=True)``. Layer and block counts are read from the
params.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

WEIGHTS_DIR = os.path.expanduser("~/.aloception_tpu/weights")

# the reference's registry names, kept verbatim so that a user who drops the
# published .pth files into WEIGHTS_DIR loads them by name
WEIGHT_REGISTRY = {
    "detr-r50": "detr-r50.pth",
    "deformable-detr-r50": "deformable-detr-r50.pth",
    "deformable-detr-r50-refinement": "deformable-detr-r50-refinement.pth",
    "raft-things": "raft-things.pth",
    "raft-chairs": "raft-chairs.pth",
    "raft-sintel": "raft-sintel.pth",
    "raft-kitti": "raft-kitti.pth",
    "raft-small": "raft-small.pth",
    "detr-r50-panoptic": "detr-r50-panoptic.pth",
}


def resolve_weights(name_or_path: str) -> str:
    """A registry name or a path -> the local file. Raises
    ``FileNotFoundError`` for a registry name whose file is not in
    ``WEIGHTS_DIR``, and for anything else that is not a file."""
    if os.path.exists(name_or_path):
        return name_or_path
    if name_or_path in WEIGHT_REGISTRY:
        path = os.path.join(WEIGHTS_DIR, WEIGHT_REGISTRY[name_or_path])
        if os.path.exists(path):
            return path
        raise FileNotFoundError(
            f"weights '{name_or_path}' not found at {path}; nothing is "
            "fetched: place the published file there")
    raise FileNotFoundError(f"unknown weights: {name_or_path}")


def load_weights(model: nn.Module, name_or_path: str) -> nn.Module:
    """Load the state dict of a registry name or a path into ``model``
    (``load_state_dict_file``: Lightning's ``model.`` prefixes dropped).
    A key that the model has and the file lacks raises ``ValueError``, as
    does a shape that differs (the JAX package's checks); keys of the file
    that the model lacks are left out. Returns ``model``."""
    sd = load_state_dict_file(resolve_weights(name_or_path))
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise ValueError(f"the weights hold no value for {len(missing)} "
                         f"model parameters, e.g. {missing[:5]}")
    for k, ref in own.items():
        if tuple(sd[k].shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{tuple(sd[k].shape)} vs {tuple(ref.shape)}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: StateDict, name: str, p: Mapping[str, Any]):
    """flax Conv (kH, kW, I, O) -> torch Conv2d (O, I, kH, kW)."""
    sd[name + ".weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])


def _dense(sd: StateDict, name: str, p: Mapping[str, Any]):
    """flax Dense kernel (I, O) -> torch Linear weight (O, I)."""
    sd[name + ".weight"] = _t(np.transpose(p["kernel"]))
    sd[name + ".bias"] = _t(p["bias"])


def _norm(sd: StateDict, name: str, p: Mapping[str, Any]):
    sd[name + ".weight"] = _t(p["scale"])
    sd[name + ".bias"] = _t(p["bias"])


def _frozen_bn(sd: StateDict, name: str, p: Mapping[str, Any]):
    _norm(sd, name, p)
    sd[name + ".running_mean"] = _t(p["mean"])
    sd[name + ".running_var"] = _t(p["var"])


def s2d_stem_to_7x7(w4: np.ndarray) -> np.ndarray:
    """Invert ``conv1_to_s2d_kernel``: a (4, 4, 4C, O) space-to-depth stem
    kernel back to the (7, 7, C, O) kernel of the 7x7/2 stem, by
    w8[2a+p, 2b+q, c] = w4[a, b, (2p+q)*C + c] and w7 = w8[1:8, 1:8]. Raises
    if w8's first row or column, which no 7x7 kernel fills, is not zero."""
    w4 = np.asarray(w4)
    C, O = w4.shape[2] // 4, w4.shape[3]
    w8 = np.zeros((8, 8, C, O), w4.dtype)
    for p in range(2):
        for q in range(2):
            w8[p::2, q::2] = w4[:, :, (2 * p + q) * C:(2 * p + q + 1) * C]
    if w8[0].any() or w8[:, 0].any():
        raise ValueError("space-to-depth stem kernel has weights outside the "
                         "7x7 window; it has no 7x7/2 equivalent")
    return w8[1:, 1:]


def backbone_state_dict_from_jax(params: Mapping[str, Any],
                                 prefix: str = "body.") -> StateDict:
    """flax ``Backbone`` params ({"trunk": ...}) -> ``Backbone`` state_dict
    (``prefix`` + ``conv1.weight``, ``layer1.0.conv1.weight`` ...). A
    space-to-depth stem is mapped back to 7x7."""
    trunk = params["trunk"]
    sd: StateDict = {}
    conv1 = np.asarray(trunk["conv1"]["kernel"])
    if conv1.shape[:2] == (4, 4):
        conv1 = s2d_stem_to_7x7(conv1)
    _conv(sd, prefix + "conv1", {"kernel": conv1})
    _frozen_bn(sd, prefix + "bn1", trunk["bn1"])
    for key, block in trunk.items():
        m = re.fullmatch(r"layer(\d+)_block(\d+)", key)
        if m is None:
            continue
        name = f"{prefix}layer{m.group(1)}.{m.group(2)}."
        for ci in (1, 2, 3):
            _conv(sd, f"{name}conv{ci}", block[f"conv{ci}"])
            _frozen_bn(sd, f"{name}bn{ci}", block[f"bn{ci}"])
        if "downsample_conv" in block:
            _conv(sd, name + "downsample.0", block["downsample_conv"])
            _frozen_bn(sd, name + "downsample.1", block["downsample_bn"])
    return sd


def mha_state_dict_from_jax(p: Mapping[str, Any], prefix: str) -> StateDict:
    """flax MultiHeadDotProductAttention {query, key, value, out} ->
    ``nn.MultiheadAttention`` (packed ``in_proj_weight``/``in_proj_bias``,
    ``out_proj``)."""
    d = np.shape(p["query"]["kernel"])[0]
    return {
        prefix + "in_proj_weight": _t(np.concatenate(
            [np.reshape(p[n]["kernel"], (d, -1)).T
             for n in ("query", "key", "value")], 0)),
        prefix + "in_proj_bias": _t(np.concatenate(
            [np.reshape(p[n]["bias"], -1) for n in ("query", "key", "value")])),
        prefix + "out_proj.weight": _t(np.reshape(p["out"]["kernel"], (-1, d)).T),
        prefix + "out_proj.bias": _t(p["out"]["bias"]),
    }


def msdeform_attn_state_dict_from_jax(p: Mapping[str, Any],
                                      prefix: str = "") -> StateDict:
    sd: StateDict = {}
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        _dense(sd, prefix + name, p[name])
    return sd


def transformer_state_dict_from_jax(p: Mapping[str, Any],
                                    prefix: str = "") -> StateDict:
    """flax ``DeformableTransformer`` params -> ``DeformableTransformer``
    state_dict (without the decoder's box heads, which the model adds)."""
    sd: StateDict = {prefix + "level_embed": _t(p["level_embed"])}
    _dense(sd, prefix + "reference_points", p["reference_points"])
    for key, layer in p.items():
        m = re.fullmatch(r"(encoder|decoder)_layer(\d+)", key)
        if m is None:
            continue
        name = f"{prefix}{m.group(1)}.layers.{m.group(2)}."
        for norm in ("norm1", "norm2", "norm3"):
            if norm in layer:
                _norm(sd, name + norm, layer[norm])
        _dense(sd, name + "linear1", layer["linear1"])
        _dense(sd, name + "linear2", layer["linear2"])
        if m.group(1) == "encoder":
            sd.update(msdeform_attn_state_dict_from_jax(layer["self_attn"],
                                                        name + "self_attn."))
        else:
            sd.update(msdeform_attn_state_dict_from_jax(layer["cross_attn"],
                                                        name + "cross_attn."))
            sd.update(mha_state_dict_from_jax(layer["self_attn"],
                                              name + "self_attn."))
    return sd


def deformable_state_dict_from_jax(params: Mapping[str, Any],
                                   with_box_refine: bool) -> StateDict:
    """flax ``DeformableDETR`` variables ({"params": ...}, or the params
    alone) -> ``DeformableDETR`` state_dict under the reference names.

    Without refinement the reference's ``class_embed.{i}``/``bbox_embed.{i}``
    are one module repeated per decoder layer, so head 0 is written under
    every index; with refinement each layer has its own heads, which the
    decoder also holds as ``transformer.decoder.bbox_embed``."""
    params = params.get("params", params)
    sd = backbone_state_dict_from_jax(params["backbone"], "backbone.0.body.")
    lvl = 0
    while f"input_proj{lvl}" in params:
        _conv(sd, f"input_proj.{lvl}.0", params[f"input_proj{lvl}"])
        _norm(sd, f"input_proj.{lvl}.1", params[f"input_proj_gn{lvl}"])
        lvl += 1
    sd["query_embed.weight"] = _t(params["query_embed"])
    sd.update(transformer_state_dict_from_jax(params["transformer"],
                                              "transformer."))

    num_dec = sum(1 for k in params["transformer"]
                  if k.startswith("decoder_layer"))
    for i in range(num_dec):
        head = i if with_box_refine else 0
        _dense(sd, f"class_embed.{i}", params[f"class_embed{head}"])
        mlp = params[f"bbox_embed{head}"]
        for j in range(len(mlp)):
            _dense(sd, f"bbox_embed.{i}.layers.{j}", mlp[f"layer{j}"])
            if with_box_refine:
                _dense(sd, f"transformer.decoder.bbox_embed.{i}.layers.{j}",
                       mlp[f"layer{j}"])
    return sd


def _raft_norm(sd: StateDict, name: str, p: Mapping[str, Any],
               stats: Mapping[str, Any]):
    """A flax norm's scale and bias; a BatchNorm's running statistics too
    when ``stats`` has them (flax keeps no batch count: 0)."""
    _norm(sd, name, p)
    if stats:
        sd[name + ".running_mean"] = _t(stats["mean"])
        sd[name + ".running_var"] = _t(stats["var"])
        sd[name + ".num_batches_tracked"] = torch.tensor(0)


def raft_encoder_state_dict_from_jax(params: Mapping[str, Any],
                                     stats: Mapping[str, Any],
                                     prefix: str = "",
                                     small: bool = False) -> StateDict:
    """flax ``BasicEncoder`` (``small``: ``SmallEncoder``) params and
    batch_stats -> its reference state_dict. Norms without params
    (instance, none) write nothing; a block's downsample norm is written
    under both of its reference names, ``normK`` and ``downsample.1``."""
    sd: StateDict = {}
    n_convs = 3 if small else 2
    _conv(sd, prefix + "conv1", params["conv1"])
    _conv(sd, prefix + "conv2", params["conv2"])
    if "norm1" in params:
        _raft_norm(sd, prefix + "norm1", params["norm1"], stats.get("norm1"))
    for li in (1, 2, 3):
        for b in (0, 1):
            name, blk = f"{prefix}layer{li}.{b}", params[f"layer{li}_{b}"]
            blk_stats = stats.get(f"layer{li}_{b}", {})
            norms = [f"norm{ci}" for ci in range(1, n_convs + 1)]
            for ci in range(1, n_convs + 1):
                _conv(sd, f"{name}.conv{ci}", blk[f"conv{ci}"])
            if "downsample" in blk:
                _conv(sd, f"{name}.downsample.0", blk["downsample"])
                norms.append(f"norm{n_convs + 1}")
                if norms[-1] in blk:
                    _raft_norm(sd, f"{name}.downsample.1", blk[norms[-1]],
                               blk_stats.get(norms[-1]))
            for norm in norms:
                if norm in blk:
                    _raft_norm(sd, f"{name}.{norm}", blk[norm],
                               blk_stats.get(norm))
    return sd


def raft_update_state_dict_from_jax(params: Mapping[str, Any],
                                    prefix: str = "",
                                    small: bool = False) -> StateDict:
    """flax ``BasicUpdateBlock`` (``small``: ``SmallUpdateBlock``) params ->
    its reference state_dict."""
    sd: StateDict = {}
    for key, conv in params["encoder"].items():
        _conv(sd, f"{prefix}encoder.{key}", conv)
    for key in ("conv1", "conv2"):
        _conv(sd, f"{prefix}flow_head.{key}", params["flow_head"][key])
    if small:
        for gate in ("convz", "convr", "convq"):
            _conv(sd, f"{prefix}gru.{gate}", params["gru"][gate])
    else:
        for gate in ("convz", "convr", "convq"):
            for i, axis in ((1, "h"), (2, "v")):
                _conv(sd, f"{prefix}gru.{gate}{i}",
                      params["gru"][f"{gate}_{axis}"])
        _conv(sd, f"{prefix}mask.0", params["mask_conv1"])
        _conv(sd, f"{prefix}mask.2", params["mask_conv2"])
    return sd


def raft_state_dict_from_jax(variables: Mapping[str, Any],
                             small: bool = False) -> StateDict:
    """flax ``RAFTBase`` variables ({"params", "batch_stats"}) -> the
    reference RAFT (``small``: RAFT-small) state_dict, the inverse of
    ``convert_raft_checkpoint``; the context encoder's BatchNorms take their
    running statistics from ``batch_stats``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: StateDict = {}
    for enc in ("fnet", "cnet"):
        sd.update(raft_encoder_state_dict_from_jax(
            params[enc], stats.get(enc, {}), f"{enc}.", small))
    sd.update(raft_update_state_dict_from_jax(params["update_block"],
                                              "update_block.", small))
    return sd


def load_state_dict_file(path: str) -> StateDict:
    """A local torch checkpoint (a state_dict, or a dict holding one under
    ``state_dict`` or ``model``) with its ``model.`` or ``module.`` key
    prefixes dropped, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    return {re.sub(r"^(model|module)\.", "", k): v for k, v in sd.items()}


def detr_layer_state_dict_from_jax(layer: Mapping[str, Any],
                                   prefix: str = "") -> StateDict:
    """flax DETR ``EncoderLayer``/``DecoderLayer`` params -> the layer's
    state_dict. The decoder's flax ``cross_attn`` is the reference's
    ``multihead_attn``."""
    sd = mha_state_dict_from_jax(layer["self_attn"], prefix + "self_attn.")
    if "cross_attn" in layer:
        sd.update(mha_state_dict_from_jax(layer["cross_attn"],
                                          prefix + "multihead_attn."))
    for norm in ("norm1", "norm2", "norm3"):
        if norm in layer:
            _norm(sd, prefix + norm, layer[norm])
    _dense(sd, prefix + "linear1", layer["linear1"])
    _dense(sd, prefix + "linear2", layer["linear2"])
    return sd


def detr_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """flax ``Detr`` variables ({"params": ...}, or the params alone) ->
    ``Detr`` state_dict under the reference names."""
    params = params.get("params", params)
    sd = backbone_state_dict_from_jax(params["backbone"], "backbone.0.body.")
    _conv(sd, "input_proj", params["input_proj"])
    sd["query_embed.weight"] = _t(params["query_embed"])
    tr = params["transformer"]
    for key, layer in tr.items():
        m = re.fullmatch(r"(encoder|decoder)_layer(\d+)", key)
        if m is not None:
            sd.update(detr_layer_state_dict_from_jax(
                layer, f"transformer.{m.group(1)}.layers.{m.group(2)}."))
    _norm(sd, "transformer.decoder.norm", tr["decoder_norm"])
    _dense(sd, "class_embed", params["class_embed"])
    mlp = params["bbox_embed"]
    for j in range(len(mlp)):
        _dense(sd, f"bbox_embed.layers.{j}", mlp[f"layer{j}"])
    return sd


def panoptic_head_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """flax ``PanopticHead`` params (``bbox_attention`` and ``mask_head``)
    -> the reference names ``bbox_attention.{q,k}_linear``,
    ``mask_head.lay{i}``/``gn{i}``/``adapter{i}``/``out_lay``."""
    sd: StateDict = {}
    for name in ("q_linear", "k_linear"):
        _dense(sd, f"bbox_attention.{name}", params["bbox_attention"][name])
    mh = params["mask_head"]
    for i in range(1, 6):
        _conv(sd, f"mask_head.lay{i}", mh[f"lay{i}_conv"])
        _norm(sd, f"mask_head.gn{i}", mh[f"lay{i}_gn"])
    for i in range(1, 4):
        _conv(sd, f"mask_head.adapter{i}", mh[f"adapter{i}"])
    _conv(sd, "mask_head.out_lay", mh["out_lay"])
    return sd


def panoptic_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """flax ``DetrPanoptic`` variables ({"params": ...}, or the params
    alone: ``detector`` and ``panoptic_head``) -> ``DetrPanoptic``
    state_dict: the detector's under ``detr.``, then the head's. A
    Deformable-DETR detector (``input_proj0``) is told from DETR by its
    params, box refinement by its per-layer heads (``class_embed1``)."""
    params = params.get("params", params)
    det = params["detector"]
    if "input_proj0" in det:
        det_sd = deformable_state_dict_from_jax(
            det, with_box_refine="class_embed1" in det)
    else:
        det_sd = detr_state_dict_from_jax(det)
    sd = {"detr." + k: v for k, v in det_sd.items()}
    sd.update(panoptic_head_state_dict_from_jax(params["panoptic_head"]))
    return sd
