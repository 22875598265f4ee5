"""Carry weights from the JAX package's Flax variables to the port.

``flax_to_state_dict`` renames and re-lays out the nested
``{"params": ..., "buffers": ...}`` tree of a detector's ``init_variables``
(numpy or array leaves; FCOS with or without ``head/centerness``, RetinaNet
with ``head/cls_subnet{i}``, ``head/bbox_subnet{i}``, ``head/cls_score`` and
the FPN's ``top_p6`` / ``top_p7`` on ``res5``; Faster R-CNN with
``rpn_head/{conv,objectness_logits,anchor_deltas}`` and
``roi_box/head/fc{i}``, ``roi_box/outputs/{cls_score,bbox_pred}``; the
proposal networks' ``PPGHead`` ``conv`` / ``offsets`` / ``in_object_logits``,
``PointsProposalHead`` ``tower{i}`` / ``gn{i}`` / ``objectness`` /
``deltas`` and ``RepPointsInitHead``; CornerNet's Hourglass and corner
heads; FrozenBN, BN and GN trunks) into a
torch ``state_dict``:

- conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``), ``kernel`` ->
  ``weight``;
- ``Dense`` kernels (in, out) -> ``nn.Linear``'s (out, in). ``fc1``'s input
  rows stay in the JAX package's (P, P, C) order, since the port pools
  channels last and flattens the same way;
- ``<name>/GroupNorm_0/{scale,bias}`` -> ``<name>.{weight,bias}``;
- a trunk's unnamed norms, FrozenBN ``buffers/.../FrozenBatchNorm_i/
  {scale,bias}``, ``BatchNorm_i`` and ``GroupNorm32_i`` -> the port's norm
  module: the ResNet's own (the stem's) ``stem_norm``; in a residual block
  ``norm1``, ``norm2``, ``norm3`` (bottleneck blocks only) and
  ``shortcut_norm`` in the order Flax numbered them;
- a trainable BatchNorm, named by position as above or by name (the RPG
  head's ``objectness_norm{i}`` and ``deltas_norm{i}``, an FPN's
  ``fpn_lateral{i}_norm``): ``params/{scale,bias}`` -> ``weight``,
  ``bias``; ``buffers/{mean,var}`` (a buffers node holding both) ->
  ``running_mean``, ``running_var``;
- the RPG head's ``moment_transfer`` keeps its name;
- ``head/scale{i}/scale`` (the ablation head's ``scale_init{i}`` and
  ``scale_refine{i}``) -> a scalar parameter;
- a Flax ``nn.GroupNorm`` named ``<tower>_gn{i}`` (the RepPoints head's
  ``cls_gn{i}`` / ``reg_gn{i}``, the ablation head's ``cls_gn{i}`` /
  ``loc_gn{i}``): ``scale`` -> ``weight``; FCOSAnchor's ``GroupNorm32``
  ``cls_gn{i}`` / ``bbox_gn{i}`` hold it under ``GroupNorm_0``;
- the ablation head's ``cls_conv`` and ``loc_refine_conv`` sit beside the
  tower convs ``cls_conv{i}``: with ``FEAT_ADAPTION`` ``Empty`` each holds a
  conv named ``conv`` (``cls_conv.conv.weight``), otherwise a raw deformable
  ``weight`` and ``bias``; no rule matches on a name prefix, so the two
  never take each other's leaves;
- a deformable conv's raw ``weight`` (K, Cin, Cout) and ``bias``
  (``DeformConvLayer``, ``DFConv2d``) keep their path and layout; the
  ``offset_conv`` under a ``DFConv2d`` is a conv like any other;
- the detector-level ``buffers/loss_normalizer`` (RepPoints' EMA) ->
  ``loss_normalizer``;
- CornerNet's Hourglass and heads: a ``ConvBNRelu`` (``ConvBNRelu_{i}``,
  ``out_conv{s}``, ``inter_a{s}``, ``inter_b{s}``, the heads' ``pool_conv1``,
  ``pool_conv2``, ``pool_out``, ``skip``, ``feat``) holds ``Conv_0`` ->
  ``conv`` and its norm ``BatchNorm_0`` (params and mean / var buffers) or
  ``FrozenBatchNorm_0`` -> ``norm``; ``Residual_{i}``, ``hg{s}``, the
  nested ``HourglassBlock_0``, ``inter_res{s}``, ``tl_head{i}``,
  ``br_head{i}`` and ``{heat,tag,offset}_{conv,out}`` keep their names;
- every other ``kernel`` / ``bias`` keeps its path, ``kernel`` as ``weight``.

It raises on any leaf it cannot place. ``load_flax_variables`` also checks
that every port tensor is filled, with matching shapes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# FrozenBatchNorm_i inside a block, in the order Flax creates them
_BOTTLENECK_NORMS = ("norm1", "norm2", "norm3", "shortcut_norm")
_BASIC_NORMS = ("norm1", "norm2", "shortcut_norm")
_BLOCK = re.compile(r"res\d+_\d+$")


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_POSITIONAL_NORM = re.compile(r"(FrozenBatchNorm|BatchNorm|GroupNorm32)_(\d+)")
_BN_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _place_norm(mods, path, basic_blocks, conv_bn_nodes):
    """``mods`` with an unnamed norm (``FrozenBatchNorm_i``, ``BatchNorm_i``
    or ``GroupNorm32_i``, numbered by Flax per class in creation order)
    renamed to the port's module: a ``ConvBNRelu``'s ``norm``; in a residual
    block ``norm1``, ``norm2``, ``norm3`` (bottleneck blocks only) and
    ``shortcut_norm``; the ResNet's own (``_0`` outside a block)
    ``stem_norm``."""
    m = _POSITIONAL_NORM.fullmatch(mods[-1]) if mods else None
    if m is None:
        return mods
    idx = int(m.group(2))
    if tuple(mods[:-1]) in conv_bn_nodes and idx == 0:
        return mods[:-1] + ["norm"]
    parent = mods[-2] if len(mods) > 1 else ""
    names = (_BASIC_NORMS if tuple(mods[:-1]) in basic_blocks else _BOTTLENECK_NORMS)
    if _BLOCK.fullmatch(parent) and idx < len(names):
        return mods[:-1] + [names[idx]]
    if not _BLOCK.fullmatch(parent) and idx == 0:
        return mods[:-1] + ["stem_norm"]
    raise KeyError(f"unplaced norm {'/'.join(path)}")


def _torch_name(collection: str, path, basic_blocks, bn_nodes, conv_bn_nodes) -> str:
    *mods, leaf = path
    if collection == "buffers" and not mods and leaf == "loss_normalizer":
        return leaf
    is_bn = collection == "buffers" and tuple(mods) in bn_nodes
    if mods and mods[-1] == "GroupNorm_0":          # GroupNorm32's inner nn.GroupNorm
        mods, leaf = mods[:-1], {"scale": "weight", "bias": "bias"}[leaf]
    if mods and mods[-1] == "Conv_0":               # a ConvBNRelu's conv
        mods = mods[:-1] + ["conv"]
    mods = _place_norm(mods, path, basic_blocks, conv_bn_nodes)
    if collection == "buffers":
        if is_bn and leaf in ("mean", "var"):
            return ".".join(mods + [_BN_LEAVES[leaf]])
        if leaf not in ("scale", "bias") or is_bn:
            raise KeyError(f"unknown buffer {'/'.join(path)}")
        return ".".join(mods + [leaf])
    if collection != "params":
        raise KeyError(f"unknown variable collection {collection!r}")
    if re.fullmatch(r"scale(_init|_refine)?\d+", mods[-1] if mods else "") \
            and leaf == "scale":
        return ".".join(mods + ["scale"])
    if leaf in ("kernel", "weight", "scale"):       # a norm's scale is its weight
        return ".".join(mods + ["weight"])
    if leaf in ("bias", "moment_transfer"):
        return ".".join(mods + [leaf])
    raise KeyError(f"unknown parameter {'/'.join(path)}")


def _basic_blocks(params: Mapping) -> set:
    """Paths of the residual blocks without a conv3: basic (two-conv)
    blocks, whose third FrozenBN is the shortcut's."""
    children: Dict[tuple, set] = {}
    for path, _ in _leaves(params):
        for i, name in enumerate(path[:-1]):
            if _BLOCK.fullmatch(name):
                children.setdefault(path[:i + 1], set()).add(path[i + 1])
    return {b for b, c in children.items() if "conv3" not in c}


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "buffers"}`` tree -> port ``state_dict``."""
    basic = _basic_blocks(variables.get("params", {}))
    # a BatchNorm's buffers node holds both mean and var
    leaves = {p[:-1]: set() for p, _ in _leaves(variables.get("buffers", {}))}
    for p, _ in _leaves(variables.get("buffers", {})):
        leaves[p[:-1]].add(p[-1])
    bn_nodes = {node for node, names in leaves.items() if {"mean", "var"} <= names}
    # a ConvBNRelu: a node whose conv is Flax's auto-named Conv_0
    conv_bn_nodes = {p[:-2] for p, _ in _leaves(variables.get("params", {}))
                     if len(p) >= 2 and p[-2] == "Conv_0"}
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            name = _torch_name(collection, path, basic, bn_nodes, conv_bn_nodes)
            a = np.asarray(value, dtype=np.float32)
            if a.ndim == 4 and name.endswith(".weight"):
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2 and name.endswith(".weight"):
                a = a.T
            if name in out:
                raise KeyError(f"two Flax leaves map to {name}")
            out[name] = torch.tensor(a)
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill every tensor of ``model`` from the Flax tree, or raise."""
    sd = flax_to_state_dict(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"bridge mismatch: missing {missing}, unexpected {extra}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: Flax shape {tuple(v.shape)} != port "
                             f"shape {tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
