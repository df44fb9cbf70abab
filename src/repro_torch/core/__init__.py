"""Multipliers, LUTs, quantization, ACUs and approximate ops."""
from .acu import (Acu, AcuMode, AttnPlan, AttnSpec, ConvPlan, ConvSpec,
                  GroupedPlan, GroupedSpec, MatmulPlan, attn_plan, conv_plan,
                  grouped_plan, make_acu, matmul_plan, resolve_conv_padding)
from .approx_ops import (ApproxConfig, approx_attention,
                         approx_attention_paged, approx_dense,
                         approx_grouped_dense, approx_matmul, conv2d,
                         conv_plan_report, separable_conv2d)
from .lut import (LowRankError, build_error_table, build_lut,
                  factorize_error, rank_for_fidelity, trunc_masks)
from .multipliers import REGISTRY, Multiplier, error_stats, get_multiplier
from .quantization import (QParams, acu_operand, affine_qparams, dequantize,
                           fake_quantize, inline_symmetric_scale, quantize,
                           symmetric_qparams)

__all__ = [
    "Acu", "AcuMode", "ApproxConfig", "AttnPlan", "AttnSpec", "ConvPlan",
    "ConvSpec", "GroupedPlan", "GroupedSpec", "LowRankError", "MatmulPlan",
    "Multiplier", "QParams", "REGISTRY", "acu_operand", "affine_qparams",
    "approx_attention", "approx_attention_paged", "approx_dense",
    "approx_grouped_dense", "approx_matmul", "attn_plan",
    "build_error_table", "build_lut", "conv2d", "conv_plan",
    "conv_plan_report", "dequantize", "error_stats", "factorize_error",
    "fake_quantize", "get_multiplier", "grouped_plan",
    "inline_symmetric_scale", "make_acu", "matmul_plan", "quantize",
    "rank_for_fidelity", "resolve_conv_padding", "separable_conv2d",
    "symmetric_qparams", "trunc_masks",
]
