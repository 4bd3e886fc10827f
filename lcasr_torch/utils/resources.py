"""Locate repo-level data files (the port's copy of
lcasr_tpu/utils/resources.py): configs/ lives beside the package.

For a source checkout this is <repo>/configs/...; for an installed package
the repo-relative path does not exist, so the current working directory is
tried before the repo-relative guess is returned (whose open() then raises
with that path).
"""
from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_repo_file(relpath: str) -> str:
    """The first existing candidate for e.g. "configs/model_zoo.yaml"."""
    candidates = [os.path.join(_REPO, relpath), os.path.join(os.getcwd(), relpath)]
    for c in candidates:
        if os.path.exists(c):
            return c
    return candidates[0]
