"""A yacs-compatible hierarchical config node.

A copy of ``slenderobjdet_tpu/config/cfg_node.py``, so that the
PyTorch port reads the same YAML files without importing the JAX package;
``tests/test_torch_package.py`` holds the two copies equal.

Behavioral parity target: detectron2/yacs ``CfgNode`` as used by the
SlenderObjDet configs. Supported features:

- attribute-style access (``cfg.MODEL.FCOS.NUM_CLASSES``)
- ``merge_from_file`` with recursive ``_BASE_`` inheritance (path relative to
  the including file, or absolute)
- ``merge_from_list(["KEY.SUBKEY", value, ...])`` dotted CLI overrides
- ``freeze()`` / ``defrost()`` / ``clone()`` / ``dump()``
- the ``!!python/object/apply:eval`` YAML tag that several reference configs
  use for computed anchor sizes (e.g. configs/retina/Base-RetinaNet.yaml)
- type checking on merge with the same coercions yacs allows
  (int<->float, list<->tuple, str "None" handling)
"""

from __future__ import annotations

import ast
import copy
import io
import os
from typing import Any, Dict, List

import yaml

BASE_KEY = "_BASE_"

_VALID_SCALARS = (int, float, bool, str, type(None))


def _check_value(value, full_key: str):
    if isinstance(value, _VALID_SCALARS):
        return
    if isinstance(value, (list, tuple)):
        for v in value:
            _check_value(v, full_key)
        return
    if isinstance(value, dict):
        for v in value.values():
            _check_value(v, full_key)
        return
    raise ValueError(
        f"Config key {full_key!r} has invalid value type {type(value)}; "
        "only scalars, lists/tuples and nested dicts are allowed"
    )


class _EvalTagLoader(yaml.SafeLoader):
    """SafeLoader extended with the single unsafe tag the reference configs use."""


def _construct_eval(loader: yaml.Loader, node: yaml.Node):
    # The reference YAMLs use both scalar form
    #   !!python/object/apply:eval "..."
    # and sequence form
    #   !!python/object/apply:eval ["..."]
    if isinstance(node, yaml.ScalarNode):
        expr = loader.construct_scalar(node)
    else:
        seq = loader.construct_sequence(node)
        if len(seq) != 1 or not isinstance(seq[0], str):
            raise ValueError(f"Unsupported eval tag payload: {seq!r}")
        expr = seq[0]
    # restricted eval: expressions in configs are pure arithmetic/list comps
    return eval(expr, {"__builtins__": {"range": range, "len": len}}, {})


_EvalTagLoader.add_constructor(
    "tag:yaml.org,2002:python/object/apply:eval", _construct_eval
)


class CfgNode(dict):
    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict: Dict | None = None, new_allowed: bool = False):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        object.__setattr__(self, CfgNode.NEW_ALLOWED, new_allowed)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v, new_allowed=new_allowed)
            dict.__setitem__(self, k, v)

    # ------------------------------------------------------------- access
    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value):
        self[name] = value

    def __setitem__(self, name, value):
        # yacs parity: direct assignment may create new keys (unless frozen);
        # key-existence validation happens only in merge_from_file/list.
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        _check_value(value, name)
        dict.__setitem__(self, name, value)

    # ------------------------------------------------------- mutability
    def freeze(self):
        self._set_immutable(True)
        return self

    def defrost(self):
        self._set_immutable(False)
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool):
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def set_new_allowed(self, flag: bool):
        object.__setattr__(self, CfgNode.NEW_ALLOWED, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(flag)

    def is_new_allowed(self) -> bool:
        return object.__getattribute__(self, CfgNode.NEW_ALLOWED)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode(new_allowed=self.is_new_allowed())
        memo[id(self)] = out
        object.__setattr__(out, CfgNode.NEW_ALLOWED, True)
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        object.__setattr__(out, CfgNode.NEW_ALLOWED, self.is_new_allowed())
        return out

    def __reduce__(self):
        return (_rebuild_cfg, (dict(self._to_plain()), self.is_new_allowed()))

    # ------------------------------------------------------------ merging
    @classmethod
    def _load_yaml_with_base(cls, filename: str) -> Dict:
        with open(filename, "r") as f:
            cfg = yaml.load(f, Loader=_EvalTagLoader)
        if cfg is None:
            cfg = {}
        if BASE_KEY in cfg:
            base_path = cfg.pop(BASE_KEY)
            if base_path.startswith("~"):
                base_path = os.path.expanduser(base_path)
            if not os.path.isabs(base_path):
                base_path = os.path.join(os.path.dirname(filename), base_path)
            base_cfg = cls._load_yaml_with_base(base_path)
            _merge_dict(base_cfg, cfg)
            return base_cfg
        return cfg

    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = True):
        loaded = CfgNode(self._load_yaml_with_base(cfg_filename), new_allowed=True)
        self.merge_from_other_cfg(loaded)

    def merge_from_other_cfg(self, other: "CfgNode"):
        _merge_cfg_into(other, self, [])

    def merge_from_list(self, cfg_list: List[Any]):
        assert len(cfg_list) % 2 == 0, f"Override list has odd length: {cfg_list}"
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            keys = full_key.split(".")
            d = self
            for sub in keys[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent key: {full_key}")
                d = d[sub]
            sub = keys[-1]
            if sub not in d:
                raise KeyError(f"Non-existent key: {full_key}")
            value = _decode_cfg_value(v)
            value = _coerce_value_type(value, d[sub], full_key)
            dict.__setitem__(d, sub, value)

    # ------------------------------------------------------------ io
    def _to_plain(self) -> Dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, CfgNode):
                out[k] = v._to_plain()
            elif isinstance(v, tuple):
                out[k] = list(v)
            else:
                out[k] = v
        return out

    def dump(self, **kwargs) -> str:
        stream = io.StringIO()
        yaml.safe_dump(self._to_plain(), stream, default_flow_style=None, **kwargs)
        return stream.getvalue()

    def __str__(self):
        def _indent(s, n):
            pad = " " * n
            return "\n".join(pad + line if line else line for line in s.split("\n"))

        lines = []
        for k, v in sorted(self.items()):
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.append(_indent(str(v), 2))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    __repr__ = __str__


def _rebuild_cfg(d, new_allowed):
    return CfgNode(d, new_allowed=new_allowed)


def _merge_dict(base: Dict, override: Dict):
    """Recursively merge plain-dict `override` into plain-dict `base` in place."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge_dict(base[k], v)
        else:
            base[k] = v


def _merge_cfg_into(src: CfgNode, dst: CfgNode, key_path: List[str]):
    for k, v in src.items():
        full_key = ".".join(key_path + [k])
        if k not in dst:
            if dst.is_new_allowed():
                dict.__setitem__(dst, k, copy.deepcopy(v))
                continue
            raise KeyError(f"Non-existent config key: {full_key}")
        if isinstance(v, (dict, CfgNode)):
            if not isinstance(dst[k], CfgNode):
                raise ValueError(f"Cannot merge dict into non-dict key {full_key}")
            _merge_cfg_into(
                v if isinstance(v, CfgNode) else CfgNode(v, new_allowed=True),
                dst[k],
                key_path + [k],
            )
        else:
            value = _coerce_value_type(_decode_cfg_value(v), dst[k], full_key)
            dict.__setitem__(dst, k, value)


def _decode_cfg_value(v):
    if isinstance(v, dict):
        return CfgNode(v, new_allowed=True)
    if not isinstance(v, str):
        return v
    # CLI overrides arrive as strings; interpret python literals where possible
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce_value_type(value, existing, full_key: str):
    if existing is None or value is None:
        return value
    value_t, existing_t = type(value), type(existing)
    if value_t == existing_t:
        return value
    # yacs-compatible coercions
    casts = [(tuple, list), (list, tuple), (int, float), (float, int), (bool, int)]
    for from_t, to_t in casts:
        if value_t is from_t and existing_t is to_t:
            return to_t(value)
    if isinstance(existing, (list, tuple)) and isinstance(value, (list, tuple)):
        return type(existing)(value)
    raise ValueError(
        f"Type mismatch ({existing_t} vs {value_t}) for config key {full_key}: "
        f"{existing!r} vs {value!r}"
    )
