"""Carry weights from the JAX package's Flax variables to the port.

``flax_to_state_dict`` renames and re-lays out the nested
``{"params": ..., "buffers": ...}`` tree of a detector's ``init_variables``
(numpy or array leaves; FCOS with or without ``head/centerness``, RetinaNet
with ``head/cls_subnet{i}``, ``head/bbox_subnet{i}``, ``head/cls_score`` and
the FPN's ``top_p6`` / ``top_p7`` on ``res5``; Faster R-CNN with
``rpn_head/{conv,objectness_logits,anchor_deltas}`` and
``roi_box/head/fc{i}``, ``roi_box/outputs/{cls_score,bbox_pred}``) into a
torch ``state_dict``:

- conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``), ``kernel`` ->
  ``weight``;
- ``Dense`` kernels (in, out) -> ``nn.Linear``'s (out, in). ``fc1``'s input
  rows stay in the JAX package's (P, P, C) order, since the port pools
  channels last and flattens the same way;
- ``<name>/GroupNorm_0/{scale,bias}`` -> ``<name>.{weight,bias}``;
- FrozenBN ``buffers/.../FrozenBatchNorm_i/{scale,bias}`` -> the port's
  norm module: the ResNet's own (the stem's) ``stem_norm``; in a residual
  block ``norm1``, ``norm2``, ``norm3`` (bottleneck blocks only) and
  ``shortcut_norm`` in the order Flax numbered them;
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


def _torch_name(collection: str, path, basic_blocks) -> str:
    *mods, leaf = path
    if collection == "buffers" and not mods and leaf == "loss_normalizer":
        return leaf
    if collection == "buffers":
        m = re.fullmatch(r"FrozenBatchNorm_(\d+)", mods[-1]) if mods else None
        if m is not None:
            idx = int(m.group(1))
            parent = mods[-2] if len(mods) > 1 else ""
            names = (_BASIC_NORMS if tuple(mods[:-1]) in basic_blocks
                     else _BOTTLENECK_NORMS)
            if _BLOCK.fullmatch(parent) and idx < len(names):
                mods = mods[:-1] + [names[idx]]
            elif not _BLOCK.fullmatch(parent) and idx == 0:
                mods = mods[:-1] + ["stem_norm"]   # the ResNet's own norm
            else:
                raise KeyError(f"unplaced FrozenBN buffer {'/'.join(path)}")
        if leaf not in ("scale", "bias"):
            raise KeyError(f"unknown buffer {'/'.join(path)}")
        return ".".join(mods + [leaf])
    if collection != "params":
        raise KeyError(f"unknown variable collection {collection!r}")
    if mods and mods[-1] == "GroupNorm_0":
        return ".".join(mods[:-1] + [{"scale": "weight", "bias": "bias"}[leaf]])
    if re.fullmatch(r"scale(_init|_refine)?\d+", mods[-1] if mods else "") \
            and leaf == "scale":
        return ".".join(mods + ["scale"])
    if re.fullmatch(r"\w+_gn\d+", mods[-1] if mods else "") and leaf == "scale":
        return ".".join(mods + ["weight"])
    if leaf in ("kernel", "weight"):
        return ".".join(mods + ["weight"])
    if leaf == "bias":
        return ".".join(mods + ["bias"])
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
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            name = _torch_name(collection, path, basic)
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
