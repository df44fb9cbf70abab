"""jamba-v0.1-52b's serving on the CPU: the port's wave and continuous
engines at ``reduced_config("jamba-v0.1-52b")`` with the fused
``mul8s_1L2H`` ACU (every GEMM on kernel 3's plain version, the experts on
kernel 10's, the attention layer on kernel 8's) give the reference
engines' greedy tokens, request for request
(``test_torch_lm_serve.engine_parity``). A slot's recurrent state is
zeroed when the continuous engine refills it, as the reference prefills a
fresh row. The paged engine refuses jamba (``test_torch_mamba_lm.py``).
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_lm_serve import engine_parity, engine_repeats  # noqa: E402


@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_engines_give_reference_tokens_jamba(engine, monkeypatch):
    """Five requests of mixed lengths and budgets through each engine:
    the reference engine's greedy tokens."""
    engine_parity(engine, "float32", "jamba-v0.1-52b", monkeypatch)


# after the reference comparison: pytest-xdist's loadfile mode hands a
# worker its next file once two tests of its current one are left, so the
# next file waits behind these two quick tests, not behind the slow one
@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_engines_serve_the_same_tokens_twice_jamba(engine):
    """Each engine serves the five requests twice with the same tokens: the
    second run starts from zeroed recurrent states and caches."""
    engine_repeats(engine, "jamba-v0.1-52b")
