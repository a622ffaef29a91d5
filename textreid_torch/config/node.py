"""A minimal yacs-compatible config tree.

The reference stack configures everything through a frozen global yacs
``CfgNode`` (``reference/lib/config/__init__.py:1-3``) merged from a YAML
file plus dotted CLI overrides (``reference/train_net.py:156-159``).  We
re-implement that contract here without depending on yacs: attribute access,
``merge_from_file`` / ``merge_from_list`` / ``freeze`` / ``clone``, and the
yacs convention of parsing python-literal strings (``"(1, 2)"`` -> tuple) so
the reference experiment YAMLs load verbatim.
"""

from __future__ import annotations

import ast
import copy
from typing import Any

import yaml

_FROZEN = "__frozen__"


def _coerce(value: Any) -> Any:
    """Mimic yacs' _decode_cfg_value: python-literal strings become values."""
    if isinstance(value, dict):
        return ConfigNode({k: _coerce(v) for k, v in value.items()})
    if isinstance(value, str):
        try:
            parsed = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
        if isinstance(parsed, (tuple, list, int, float, bool, complex)):
            return parsed
        return value
    if isinstance(value, list):
        return [_coerce(v) for v in value]
    return value


def _check_type(old: Any, new: Any, key: str) -> Any:
    """Coerce `new` to the type of `old` where yacs would, else raise."""
    if old is None or type(old) is type(new):
        return new
    # Compatible casts yacs allows.
    casts = [(tuple, list), (list, tuple), (int, float), (float, int),
             (str, type(None)), (type(None), str)]
    for old_t, new_t in casts:
        if isinstance(old, old_t) and isinstance(new, new_t):
            return old_t(new) if not isinstance(new, type(None)) else new
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    raise TypeError(
        f"Type mismatch for config key '{key}': {type(old).__name__} vs "
        f"{type(new).__name__} ({new!r})"
    )


class ConfigNode(dict):
    """dict with attribute access, freezing, and yacs-style merging."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                super().__setitem__(k, _coerce(v) if isinstance(v, dict) else v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set '{name}': config is frozen")
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set '{key}': config is frozen")
        super().__setitem__(key, value)

    # -- lifecycle -----------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def clone(self) -> "ConfigNode":
        node = ConfigNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return node

    # -- merging ---------------------------------------------------------------
    def merge_from_other(self, other: dict, prefix: str = "") -> None:
        for key, value in other.items():
            full = f"{prefix}.{key}" if prefix else key
            if key not in self:
                raise KeyError(f"Non-existent config key: {full}")
            value = _coerce(value)
            if isinstance(self[key], ConfigNode):
                if not isinstance(value, dict):
                    raise TypeError(f"Cannot overwrite subtree '{full}' with a leaf")
                self[key].merge_from_other(value, full)
            else:
                super().__setitem__(key, _check_type(self[key], value, full))

    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        self.merge_from_other(loaded)

    def merge_from_list(self, opts: list) -> None:
        if opts is None:
            return
        assert len(opts) % 2 == 0, f"Override list must be key/value pairs: {opts}"
        for dotted, value in zip(opts[0::2], opts[1::2]):
            node = self
            *parents, leaf = dotted.split(".")
            for p in parents:
                node = node[p]
                if not isinstance(node, ConfigNode):
                    raise KeyError(f"'{dotted}': '{p}' is not a config subtree")
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {dotted}")
            value = _coerce(value)
            dict.__setitem__(node, leaf, _check_type(node[leaf], value, dotted))

    # -- dump ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }

    def dump(self) -> str:
        def _plain(v):
            if isinstance(v, ConfigNode):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, tuple):
                return list(v)
            return v

        return yaml.safe_dump(_plain(self), sort_keys=True)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.dump()
