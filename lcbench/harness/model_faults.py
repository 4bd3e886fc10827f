"""Faults of the mechanisms that later cells brought, planted under the timed
path to show that `correct` comes out false when the program is wrong
(`faults.py` holds the first cells'; `lcbench/plant.py` runs a cell with one
of these).  No benchmark run plants one.

  position_term_dropped  the relative-position attention op runs with its
                         position table zeroed (p = 0): the scores keep the
                         content term alone.
"""
from __future__ import annotations

import contextlib

FAULTS = ("position_term_dropped",)


@contextlib.contextmanager
def planted(name):
    """Plant the fault `name` (None: nothing) for as long as the context is open."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}: one of {FAULTS}")
    import lcasr_torch.ops.rel_pos_attention as owner

    inner = owner.rel_pos_attention

    def without_position(q, k, v, pos, bias_u, bias_v, lengths=None):
        return inner(q, k, v, pos * 0, bias_u, bias_v, lengths)

    owner.rel_pos_attention = without_position
    try:
        yield
    finally:
        owner.rel_pos_attention = inner
