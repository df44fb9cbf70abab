"""The wave engine serving granite-moe-3b-a800m reduced with the fused ACU
against the reference engine's greedy tokens, at capacity 8.0 and 1.0
(tolerances and the op-by-op rule: ``test_torch_moe_lm.py``'s docstring).

One engine per file (``test_torch_moe_engine_{wave,continuous,paged}.py``)
so that a run that hands out whole files to its workers runs the three
engines side by side.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_lm_serve import engine_parity, engine_repeats  # noqa: E402


@pytest.mark.parametrize("capacity", [8.0, 1.0])
@pytest.mark.parametrize("engine", ["wave"])
def test_moe_engines_give_reference_tokens(engine, capacity, monkeypatch):
    """Five requests of mixed lengths and budgets through the engine with
    the fused ACU, granite-moe-3b-a800m reduced: the reference engine's
    greedy tokens, with ample capacity and with dropping capacity (against
    the reference run op by op)."""
    engine_parity(engine, "float32", "granite-moe-3b-a800m", monkeypatch,
                  op_by_op=capacity < 8.0, moe_capacity=capacity)


# after the reference comparison: pytest-xdist's loadfile mode hands a
# worker its next file once two tests of its current one are left, so the
# next file waits behind these two quick tests, not behind the slow one
@pytest.mark.parametrize("capacity", [8.0, 1.0])
@pytest.mark.parametrize("engine", ["wave"])
def test_moe_engine_serves_the_same_tokens_twice(engine, capacity):
    """The engine serves the five requests twice with the same tokens, at
    ample and at dropping capacity (which experts drop a token is settled
    within each batch, the same way each time)."""
    engine_repeats(engine, "granite-moe-3b-a800m", moe_capacity=capacity)
