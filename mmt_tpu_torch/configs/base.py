"""Dataclass config base with strict nested overrides and yaml IO.

PyTorch-port copy of ``mmt_tpu/configs/base.py``: the same strict-key
override semantics, so a yaml written for the JAX package loads here to
the same field values.  ``yaml`` is imported only by the two functions
that parse yaml, so the rest of the package imports without it.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, TypeVar

T = TypeVar("T", bound="Config")


@dataclasses.dataclass
class Config:
    """Base class: nested dataclass configs with strict dict overrides."""

    def replace(self: T, **kwargs) -> T:
        return dataclasses.replace(self, **kwargs)

    def as_dict(self) -> Dict[str, Any]:
        return to_dict(self)


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def override(cfg: T, overrides: Dict[str, Any], strict: bool = True, _path: str = "") -> T:
    """Returns a new config with nested dict overrides applied.

    Strict mode raises KeyError on unknown keys.  List-of-config fields
    are replaced wholesale: each element dict is built against the
    field's element type if the current list is non-empty and typed,
    else kept raw.
    """
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"override target at {_path or '<root>'} is not a config")
    field_map = {f.name: f for f in dataclasses.fields(cfg)}
    try:
        hints = typing.get_type_hints(type(cfg))
    except (NameError, TypeError):
        hints = {}
    updates: Dict[str, Any] = {}
    for key, value in overrides.items():
        path = f"{_path}.{key}" if _path else key
        if key not in field_map:
            if strict:
                raise KeyError(f"Unknown config key: {path}")
            continue
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = override(current, value, strict=strict, _path=path)
        elif isinstance(current, list) and value and all(
            isinstance(v, dict) for v in value
        ):
            if current and dataclasses.is_dataclass(current[0]):
                elem_cls = type(current[0])
                updates[key] = [elem_cls(**v) for v in value]
            else:
                elem_cls = _element_type(hints.get(key, field_map[key].type))
                updates[key] = [elem_cls(**v) for v in value] if elem_cls else list(value)
        else:
            updates[key] = value
    return dataclasses.replace(cfg, **updates)


def _element_type(annotation):
    args = getattr(annotation, "__args__", None)
    if args and dataclasses.is_dataclass(args[0]):
        return args[0]
    return None


def from_yaml_file(cfg: T, path: str, strict: bool = True) -> T:
    import yaml

    with open(path) as f:
        overrides = yaml.safe_load(f) or {}
    return override(cfg, overrides, strict=strict)


def parse_params_override(cfg: T, params_override: str, strict: bool = True) -> T:
    """Applies a ``a.b.c=v,x.y=w`` or yaml/json string override."""
    if not params_override:
        return cfg
    import yaml

    try:
        data = yaml.safe_load(params_override)
    except yaml.YAMLError:
        data = None
    if not isinstance(data, dict):
        data = {}
        for item in params_override.split(","):
            key, _, value = item.partition("=")
            sub = data
            parts = key.strip().split(".")
            for p in parts[:-1]:
                sub = sub.setdefault(p, {})
            sub[parts[-1]] = yaml.safe_load(value)
    return override(cfg, data, strict=strict)
