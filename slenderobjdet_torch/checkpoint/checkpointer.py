"""Checkpointing: save and resume of the train state, and detectron2-pkl
weight import (counterpart of ``slenderobjdet_tpu/checkpoint/checkpointer.py``
and of the reference's `DetectionCheckpointer`,
`slender_det/checkpoint/checkpoint.py:11-63` + fvcore Checkpointer):

- periodic save of ``{"model", "optimizer", "iteration"}`` (``torch.save`` of
  state dicts; ``torch.load(weights_only=True)`` reads them back) with a
  `last_checkpoint` pointer file and resume_or_load semantics;
- MODEL.WEIGHTS loading: a ``.pkl`` in the detectron2 model-zoo format is
  imported by name into the port's ``state_dict`` with the BatchNorm
  statistics folded into FrozenBN's scale and bias; a ``.pth`` written by
  `DetectionCheckpointer.save` gives its model weights.

The d2 import fills the same tensors with the same values as the JAX
package's import followed by ``checkpoint/bridge.py``
(``tests/test_torch_checkpoint.py``). The PVT zoo import is not ported yet.
"""

from __future__ import annotations

import os
import pickle
import re
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], state: Any) -> Any:
    """``state`` (nested dicts, lists and tuples) rebuilt with ``fn`` applied
    to every tensor; other leaves as they are."""
    if isinstance(state, torch.Tensor):
        return fn(state.detach())
    if isinstance(state, dict):
        return {k: _map_tensors(fn, v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_map_tensors(fn, v) for v in state)
    return state


class DetectionCheckpointer:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------- save/load
    def save(self, name: str, state: Dict, blocking: bool = True):
        """Persist `state` (nested dicts and lists of tensors and plain
        values) as ``<name>.pth``. With blocking=False the state is cloned
        where it lives, and the fetch to the host and the write run in a
        background thread (periodic-save mode); at most one save is in
        flight, and a new one first joins the previous. The thread does not
        yet free the train loop: its ``.cpu()`` copies go to pageable memory
        on the default stream, behind the steps enqueued after the clone,
        and it shares the interpreter lock with the loop, which was measured
        to stall at the saving iteration (``PERF.md``, section 5). The
        `last_checkpoint` pointer is written only AFTER the data is on disk,
        so a crash mid-save can never leave a stale pointer."""
        self.wait()

        if not blocking:
            # The optimizer updates parameters and momentum in place: by the
            # time a background thread reads them the next step may have
            # changed them. Clone each tensor where it lives first (on the
            # card a copy enqueued before that step).
            state = _map_tensors(torch.clone, state)

        def do_save():
            path = os.path.join(self.save_dir, name + ".pth")
            tmp = path + ".tmp"
            torch.save(_map_tensors(torch.Tensor.cpu, state), tmp)
            os.replace(tmp, path)
            with open(os.path.join(self.save_dir, "last_checkpoint"),
                      "w") as f:
                f.write(name)

        if blocking:
            do_save()
        else:
            def guarded():
                try:
                    do_save()
                except BaseException as e:  # surfaced by wait()
                    self._error = e

            self._error = None
            self._pending = threading.Thread(target=guarded, daemon=True)
            self._pending.start()

    def wait(self):
        """Join any in-flight non-blocking save; re-raise its failure."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            err, self._error = self._error, None
            if err is not None:
                raise RuntimeError("async checkpoint save failed") from err

    def has_checkpoint(self) -> bool:
        self.wait()
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> Optional[str]:
        self.wait()
        p = os.path.join(self.save_dir, "last_checkpoint")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return os.path.join(self.save_dir, f.read().strip())

    def load(self, path: str) -> Dict:
        """The state a `save` wrote, tensors on the CPU."""
        if not path.endswith(".pth"):
            path = path + ".pth"
        return torch.load(path, map_location="cpu", weights_only=True)

    def resume_or_load(self, weights_path: str, model: nn.Module,
                       optimizer: Optional[torch.optim.Optimizer],
                       resume: bool) -> int:
        """d2 semantics: if resume and a checkpoint exists, restore model,
        optimizer and iteration from it; otherwise (re)initialize the model
        from MODEL.WEIGHTS (parameters and FrozenBN buffers only). Returns
        the iteration to start from."""
        if resume and self.has_checkpoint():
            state = self.load(self.get_checkpoint_file())
            model.load_state_dict(state["model"], strict=True)
            if optimizer is not None:
                optimizer.load_state_dict(state["optimizer"])
            return int(state["iteration"])
        if weights_path:
            load_model_weights(weights_path, model)
        return 0


# ----------------------------------------------------------- d2 pkl import
def load_model_weights(path: str, model: nn.Module) -> None:
    """Load MODEL.WEIGHTS into ``model``. Supports d2 .pkl zoo files and the
    .pth checkpoints this package writes."""
    if path.endswith(".pkl"):
        # a model-zoo file is a pickle by format: load only files you trust
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        state_dict = data.get("model", data)
        import_d2_weights(state_dict, model)
        return
    if path.endswith((".pth", ".pt")):
        data = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(data, dict) and "model" in data and "iteration" in data:
            model.load_state_dict(data["model"], strict=True)
            return
        if isinstance(data, dict):
            data = data.get("model", data.get("state_dict", data))
        if any(k.split("module.", 1)[-1].startswith("patch_embed1")
               for k in data):
            import_pvt_weights(data, model)
            return
        raise ValueError(
            f"{path!r}: not a checkpoint of this package (no 'model' and "
            "'iteration' entries) and not a PVT zoo file")
    raise ValueError(f"Unsupported weights file {path!r}")


def _d2_resnet_name_map(d2_name: str) -> Optional[tuple]:
    """Map a detectron2 ResNet/FPN parameter name to (our module path, leaf).

    d2 names (backbone.bottom_up prefix optional):
      stem.conv1.{weight,norm.weight,norm.bias,norm.running_mean,...}
      res{S}.{B}.conv{1,2,3}.{weight,norm.*}
      res{S}.{B}.shortcut.{weight,norm.*}
      fpn_lateral{L}.{weight,bias}, fpn_output{L}.{weight,bias}
      top_block.p6.{weight,bias}, top_block.p7.{weight,bias}
    """
    name = d2_name
    for prefix in ("backbone.bottom_up.", "backbone.", "bottom_up."):
        if name.startswith(prefix):
            name = name[len(prefix):]

    m = re.match(r"stem\.conv1\.(.*)", name)
    if m:
        return ("stem_conv1", "stem"), m.group(1)

    m = re.match(r"res(\d)\.(\d+)\.(conv\d|shortcut)\.(.*)", name)
    if m:
        stage, block, conv, rest = m.groups()
        return (f"res{stage}_{block}", conv), rest

    m = re.match(r"fpn_lateral(\d)\.(weight|bias)", name)
    if m:
        # d2 numbers laterals by stage (3,4,5); ours by index (0,1,2)
        return (f"fpn_lateral_stage{m.group(1)}", None), m.group(2)
    m = re.match(r"fpn_output(\d)\.(weight|bias)", name)
    if m:
        return (f"fpn_output_stage{m.group(1)}", None), m.group(2)
    m = re.match(r"top_block\.p(\d)\.(weight|bias)", name)
    if m:
        return (f"top_p{m.group(1)}", None), m.group(2)
    return None


def import_d2_weights(state_dict: Dict[str, np.ndarray],
                      model: nn.Module) -> None:
    """Import detectron2 ResNet-FPN weights (OIHW, the port's own layout)
    into ``model``. Folds BatchNorm running stats into FrozenBN scale/bias.
    Unmatched destination tensors keep their initialized values."""
    own = model.state_dict()
    new: Dict[str, np.ndarray] = {}

    loaded = 0
    norms: Dict[str, Dict[str, np.ndarray]] = {}
    in_features_order = []  # lateral/output stage numbers, sorted
    for k in state_dict:
        m = re.match(r"(?:backbone\.)?(?:bottom_up\.)?fpn_lateral(\d)\.weight", k)
        if m:
            in_features_order.append(int(m.group(1)))
    in_features_order.sort()
    stage_to_idx = {s: i for i, s in enumerate(in_features_order)}

    def put_param(path_tuple, value):
        nonlocal loaded
        key = ".".join(path_tuple)
        # a deformable conv2's (K, Cin, Cout) weight has no d2 counterpart
        # here and keeps its initialisation, as the JAX import leaves it
        if key in own and own[key].ndim != 3:
            if tuple(own[key].shape) != value.shape:
                raise ValueError(f"shape mismatch {key}: "
                                 f"{tuple(own[key].shape)} vs {value.shape}")
            new[key] = value.astype(np.float32)
            loaded += 1

    for d2_name, value in state_dict.items():
        value = np.asarray(value)
        mapped = _d2_resnet_name_map(d2_name)
        if mapped is None:
            continue
        (module, sub), rest = mapped

        # translate lateral/output stage numbering to index numbering
        m = re.match(r"fpn_(lateral|output)_stage(\d)", module)
        if m:
            idx = stage_to_idx.get(int(m.group(2)))
            if idx is None:
                continue
            module = f"fpn_{m.group(1)}{idx}"

        if rest in ("weight", "bias") and value.ndim == (4 if rest == "weight" else 1):
            if module == "stem_conv1":
                if rest == "weight":
                    put_param(("backbone", "bottom_up", "stem_conv1", rest), value)
            elif sub in ("conv1", "conv2", "conv3", "shortcut"):
                put_param(("backbone", "bottom_up", module, sub, rest), value)
            else:  # fpn lateral/output/top convs live directly under backbone
                put_param(("backbone", module, rest), value)
        elif rest.startswith("norm."):
            norms.setdefault(f"{module}|{sub}", {})[rest[len("norm."):]] = value

    # fold norm stats: FrozenBN y = x * s + b with
    # s = weight / sqrt(var + eps), b = bias - mean * s
    eps = 1e-5
    for key, stats in norms.items():
        module, sub = key.split("|")
        need = {"weight", "bias", "running_mean", "running_var"}
        if not need.issubset(stats):
            continue
        s = stats["weight"] / np.sqrt(stats["running_var"] + eps)
        b = stats["bias"] - stats["running_mean"] * s
        for pfx in _frozen_bn_path(own, module, sub):
            new[pfx + ".scale"] = s.astype(np.float32)
            new[pfx + ".bias"] = b.astype(np.float32)
            loaded += 1

    if loaded == 0:
        raise ValueError("no weights matched the d2 name mapping")
    with torch.no_grad():
        for key, value in new.items():
            own[key].copy_(torch.from_numpy(np.ascontiguousarray(value)))


def import_pvt_weights(state_dict, model: nn.Module) -> None:
    raise NotImplementedError(
        "import_pvt_weights is not ported: the PVT / PVTv2 zoo import comes "
        "with the PVT and VT-FPN backbones")


def _frozen_bn_path(own: Dict[str, torch.Tensor], module: str,
                    sub: str) -> List[str]:
    """The FrozenBN that follows a conv, by the port's module names: the
    stem's ``stem_norm``; in a block ``norm1``-``norm3`` after
    ``conv1``-``conv3`` and ``shortcut_norm`` after ``shortcut``."""
    if module == "stem_conv1":
        prefix = "backbone.bottom_up.stem_norm"
    else:
        norm = {"conv1": "norm1", "conv2": "norm2", "conv3": "norm3",
                "shortcut": "shortcut_norm"}.get(sub)
        if norm is None:
            return []
        prefix = f"backbone.bottom_up.{module}.{norm}"
    return [prefix] if prefix + ".scale" in own else []
