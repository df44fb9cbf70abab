"""Paper-side evaluation CNNs (port of ``repro.models.vision``: the
VGG-style CNN and the ResNet; SqueezeNet, VAE and GAN wait).

Parameters are plain dicts of tensors with the reference's names and
layouts (conv weights OIHW, dense weights (K, N)), so
:func:`load_jax_params` carries the reference's parameters over unchanged
and both packages compute the same function. Every conv and dense layer
routes through ``repro_torch.core``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.approx_ops import ApproxConfig, approx_dense
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.layers import conv2d_block


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _conv_init(g, cout, cin, kh, kw):
    s = (cin * kh * kw) ** -0.5
    return torch.randn((cout, cin, kh, kw), generator=g) * s


def _lin_init(g, din, dout):
    return torch.randn((din, dout), generator=g) * din ** -0.5


def _to(p: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: v.to(device=dev, dtype=torch.float32) for k, v in p.items()}


def load_jax_params(np_params: dict, device=None) -> dict:
    """The reference's parameter dict (numpy arrays, e.g. ``{k:
    np.asarray(v)}`` of a ``repro.models.vision`` init) as the port's: same
    names and layouts, float32 tensors on ``device`` (``cuda`` unless
    given)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in np_params.items()}


# ---------------------------------------------------------------------------
# Small VGG-style CNN (the CIFAR10 CNN rows)
# ---------------------------------------------------------------------------

def init_cnn(seed: int = 0, n_classes: int = 10, width: int = 32,
             in_ch: int = 3, img: int = 32, device=None) -> dict:
    """Random CNN parameters from ``seed`` (a ``torch.Generator``; the
    numbers differ from the reference's ``jax.random`` init)."""
    g = _generator(seed)
    w = width
    flat = 4 * w * (img // 8) ** 2   # three 2x2 pools
    return _to({
        "c1": _conv_init(g, w, in_ch, 3, 3), "b1": torch.zeros(w),
        "c2": _conv_init(g, 2 * w, w, 3, 3), "b2": torch.zeros(2 * w),
        "c3": _conv_init(g, 4 * w, 2 * w, 3, 3), "b3": torch.zeros(4 * w),
        "f1": _lin_init(g, flat, 8 * w), "fb1": torch.zeros(8 * w),
        "f2": _lin_init(g, 8 * w, n_classes),
        "fb2": torch.zeros(n_classes),
    }, device)


def cnn_forward(p: dict, x: torch.Tensor,
                acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    """x: (N, C, 32, 32) -> logits (N, n_classes)."""
    pool = lambda t: F.max_pool2d(t, 2, 2)
    x = pool(conv2d_block(x, p["c1"], p["b1"], acfg=acfg,
                          activation=torch.relu))
    x = pool(conv2d_block(x, p["c2"], p["b2"], acfg=acfg,
                          activation=torch.relu))
    x = pool(conv2d_block(x, p["c3"], p["b3"], acfg=acfg,
                          activation=torch.relu))
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(approx_dense(x, p["f1"], p["fb1"], acfg))
    return approx_dense(x, p["f2"], p["fb2"], acfg)


# ---------------------------------------------------------------------------
# ResNet (basic blocks); width=16, n_blocks=3 is ResNet-20 for CIFAR-10
# ---------------------------------------------------------------------------

def init_resnet(seed: int = 0, n_classes: int = 10, width: int = 16,
                n_blocks: int = 3, device=None) -> dict:
    """Random ResNet parameters from ``seed``, the reference's names and
    shapes: stem, three stages of ``n_blocks`` basic blocks (16/32/64
    channels at width 16), 1x1 shortcuts where shape changes, dense head."""
    g = _generator(seed)
    p: dict = {"stem": _conv_init(g, width, 3, 3, 3),
               "stem_b": torch.zeros(width)}
    w = width
    for stage in range(3):
        wo = width * (2 ** stage)
        for blk in range(n_blocks):
            pre = f"s{stage}b{blk}"
            stride = 2 if (blk == 0 and stage > 0) else 1
            cin = w if blk == 0 else wo
            p[f"{pre}_c1"] = _conv_init(g, wo, cin, 3, 3)
            p[f"{pre}_c2"] = _conv_init(g, wo, wo, 3, 3)
            if cin != wo or stride != 1:
                p[f"{pre}_sc"] = _conv_init(g, wo, cin, 1, 1)
        w = wo
    p["head"] = _lin_init(g, w, n_classes)
    p["head_b"] = torch.zeros(n_classes)
    return _to(p, device)


def resnet_forward(p: dict, x: torch.Tensor,
                   acfg: Optional[ApproxConfig] = None,
                   n_blocks: int = 3) -> torch.Tensor:
    x = conv2d_block(x, p["stem"], p["stem_b"], acfg=acfg,
                     activation=torch.relu)
    for stage in range(3):
        for blk in range(n_blocks):
            pre = f"s{stage}b{blk}"
            stride = (2, 2) if (blk == 0 and stage > 0) else (1, 1)
            h = conv2d_block(x, p[f"{pre}_c1"], None, stride=stride,
                             acfg=acfg, activation=torch.relu)
            h = conv2d_block(h, p[f"{pre}_c2"], None, acfg=acfg)
            sc = x if f"{pre}_sc" not in p else conv2d_block(
                x, p[f"{pre}_sc"], None, stride=stride, padding="VALID",
                acfg=acfg)
            x = torch.relu(h + sc)
    x = x.mean(dim=(2, 3))
    return approx_dense(x, p["head"], p["head_b"], acfg)
