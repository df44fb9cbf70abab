"""command-r-plus-104b (the parallel block with layer norm) against the JAX reference on the CPU at its
``reduced_config``: ``apply_model``'s float32 logits on the exact, LUT and
fused routes, and the three engines' greedy tokens. The cases and their
tolerances are ``lm_arch_cases.py``'s.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from lm_arch_cases import (ARCH_ENGINES, ARCH_ROUTES,  # noqa: E402
                           engine_case, float32_logits_case)
from test_torch_lm import ref  # noqa: E402

__all__ = ["ref"]        # the fixture, shared with test_torch_lm.py


@pytest.mark.parametrize("arch", ["command-r-plus-104b"])
@pytest.mark.parametrize("route", ARCH_ROUTES)
def test_apply_model_other_archs_float32_logits(ref, route, arch):
    """Prefill and one decode step against the reference's apply_model."""
    float32_logits_case(ref, route, arch)


@pytest.mark.parametrize("arch", ["command-r-plus-104b"])
@pytest.mark.parametrize("engine", ARCH_ENGINES)
def test_engines_give_reference_tokens_other_archs(engine, arch,
                                                   monkeypatch):
    """The reference engine's greedy tokens, request for request."""
    engine_case(engine, arch, monkeypatch)
