"""Config system: YAML-backed nested config with attribute access and
``${a.b}`` interpolation (the port's copy of lcasr_tpu/config.py).

`yaml` is imported only where a YAML file or value is read or written
(`load`, `save`, `apply_overrides`): the port itself never needs pyyaml,
and a config built with `Config(dict)` works without it.

Plays the role OmegaConf plays in the reference (reference `exp/train.py:356`,
`eval/run.py:31-33`): one config object flows through training and eval, is
embedded verbatim in every checkpoint, and eval rebuilds the model purely from
the checkpoint's embedded config.  Implemented standalone because omegaconf is
not a dependency of this framework.
"""
from __future__ import annotations

import copy
import json
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config(Mapping):
    """Nested dict with attribute access, ``in``/``get`` support and
    ``${dot.path}`` interpolation resolved against the root config."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, _root: "Config" = None):
        object.__setattr__(self, "_data", dict(data or {}))
        object.__setattr__(self, "_root", _root if _root is not None else self)

    # -- construction ------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f) or {})

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls(copy.deepcopy(d))

    def save(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    # -- access ------------------------------------------------------------
    def _wrap(self, value: Any) -> Any:
        if isinstance(value, Config):
            return Config(value._data, _root=self._root)
        if isinstance(value, dict):
            return Config(value, _root=self._root)
        if isinstance(value, str):
            return self._interpolate(value)
        if isinstance(value, list):
            return [self._wrap(v) for v in value]
        return value

    def _interpolate(self, s: str) -> Any:
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation keeps the referenced value's type
            return self._root.select(m.group(1))
        return _INTERP_RE.sub(lambda mo: str(self._root.select(mo.group(1))), s)

    def select(self, dot_path: str, default: Any = None) -> Any:
        node: Any = self
        for part in dot_path.split("."):
            if isinstance(node, Config):
                if part not in node._data:
                    return default
                node = node._wrap(node._data[part])
            elif isinstance(node, list):
                node = node[int(part)]
            else:
                return default
        return node

    def __getattr__(self, key: str) -> Any:
        try:
            return self._wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value.to_dict() if isinstance(value, Config) else value

    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self.__setattr__(key, value)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._wrap(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self._wrap(v)) for k, v in self._data.items()]

    # -- conversion / merging ---------------------------------------------
    def to_dict(self, resolve: bool = False) -> Dict[str, Any]:
        def conv(v: Any) -> Any:
            if isinstance(v, Config):
                return v.to_dict(resolve)
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            if resolve and isinstance(v, str):
                return self._interpolate(v)
            return v

        return {k: conv(v) for k, v in self._data.items()}

    def merge(self, other: "Config | Dict[str, Any]") -> "Config":
        """Deep-merge `other` on top of self, returning a new Config."""
        def deep(a: Dict, b: Dict) -> Dict:
            out = dict(a)
            for k, v in b.items():
                if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                    out[k] = deep(out[k], v)
                else:
                    out[k] = copy.deepcopy(v)
            return out

        other_d = other.to_dict() if isinstance(other, Config) else other
        return Config(deep(self.to_dict(), other_d))

    def apply_overrides(self, overrides: List[str]) -> "Config":
        """Apply `a.b.c=value` dot-list overrides (values parsed as YAML)."""
        import yaml

        cfg = self.to_dict()
        for ov in overrides:
            path, _, raw = ov.partition("=")
            node = cfg
            parts = path.strip().split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = yaml.safe_load(raw)
        return Config(cfg)

    def __repr__(self) -> str:
        return f"Config({json.dumps(self.to_dict(), indent=2, default=str)})"
