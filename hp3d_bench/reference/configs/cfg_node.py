"""A minimal yacs-compatible configuration node.

The reference uses yacs `CfgNode` trees (reference: configs/poseMF_shapeGaussian_net_config.py).
yacs is not available in this environment, so this module provides a drop-in
subset: attribute access, `clone()`, `merge_from_file()` (YAML) and
`merge_from_list()` with the same type-checking semantics, plus YAML dumping so
experiment-config snapshots written by the reference remain loadable and
vice versa.
"""

from __future__ import annotations

import copy
from typing import Any, List

import yaml


class CfgNode(dict):
    """Nested dict with attribute access and yacs-style merge semantics."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        for k, v in init_dict.items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # -- yacs API ----------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def dump(self) -> str:
        return yaml.safe_dump(_to_plain(self), default_flow_style=False)

    def merge_from_file(self, cfg_filename: str) -> None:
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_a_into_b(CfgNode(loaded), self, [])

    def merge_from_other_cfg(self, cfg_other: "CfgNode") -> None:
        _merge_a_into_b(cfg_other, self, [])

    def merge_from_list(self, cfg_list: List[Any]) -> None:
        assert len(cfg_list) % 2 == 0, (
            f"Override list has odd length: {cfg_list}; it must be a list of pairs")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            d = self
            key_parts = full_key.split(".")
            for sub_key in key_parts[:-1]:
                assert sub_key in d, f"Non-existent key: {full_key}"
                d = d[sub_key]
            sub_key = key_parts[-1]
            assert sub_key in d, f"Non-existent key: {full_key}"
            value = _decode_value(v)
            value = _check_and_coerce(value, d[sub_key], full_key)
            d[sub_key] = value


def _to_plain(node):
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    return node


def _decode_value(v):
    if not isinstance(v, str):
        return v
    try:
        parsed = yaml.safe_load(v)
    except yaml.YAMLError:
        return v
    return parsed


def _check_and_coerce(value, original, full_key):
    original_type = type(original)
    replacement_type = type(value)
    if replacement_type == original_type or original is None:
        return value
    # yacs-compatible casts
    casts = [(tuple, list), (list, tuple), (int, float)]
    for (from_type, to_type) in casts:
        if replacement_type == from_type and original_type == to_type:
            return to_type(value)
    raise ValueError(
        f"Type mismatch ({original_type} vs {replacement_type}) for key {full_key}")


def _merge_a_into_b(a: CfgNode, b: CfgNode, key_path: List[str]) -> None:
    for k, v_ in a.items():
        full_key = ".".join(key_path + [k])
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        v = CfgNode(v_) if isinstance(v_, dict) and not isinstance(v_, CfgNode) else v_
        if isinstance(v, CfgNode):
            _merge_a_into_b(v, b[k], key_path + [k])
        else:
            b[k] = _check_and_coerce(v, b[k], full_key)
