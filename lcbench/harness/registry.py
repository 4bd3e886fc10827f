"""Everything a run needs, found by name under `lcbench/`, so that a new cell,
configuration, traffic mix or metric is a new file and no edit:

  workloads/<cell>.json      {"config", "traffic", "chips", "why", "limits"}
  configs/<config>.json      the model configuration as it is run
  traffic/<traffic>.json     {"driver", ...the mix's parameters}
  drivers/<driver>.py        run(ctx) -> Outcome, one per kind of path
  metrics/<metric>.py        one per-layer metric: UNIT, SOURCE, LAYER,
                             MOVES and read(view) -> value or None
"""
from __future__ import annotations

import importlib
import json
import os
import re
from types import ModuleType
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # lcbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid {kind} name: {name!r}")
    path = os.path.join(ROOT, kind, name + ext)
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def _json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(kind: str, name: str) -> ModuleType:
    _path(kind, name, ".py")
    return importlib.import_module(f"lcbench.{kind}.{name}")


def driver(name: str) -> ModuleType:
    return _module("drivers", name)


def names(kind: str, ext: str):
    folder = os.path.join(ROOT, kind)
    return sorted(f[: -len(ext)] for f in os.listdir(folder)
                  if f.endswith(ext) and not f.startswith("_") and NAME.match(f[: -len(ext)]))


def metrics() -> Dict[str, ModuleType]:
    """Every per-layer metric, by its name (the file's name: dots allowed,
    so it is loaded from its path)."""
    import importlib.util

    out = {}
    for name in names("metrics", ".py"):
        spec = importlib.util.spec_from_file_location(
            f"lcbench.metrics.{name.replace('.', '_')}",
            os.path.join(ROOT, "metrics", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out
