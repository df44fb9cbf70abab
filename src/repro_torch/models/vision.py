"""Paper-side evaluation models (port of ``repro.models.vision``: the
VGG-style CNN, the ResNet, the SqueezeNet-style CNN, the VAE and the GAN).

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
    """The reference's parameter dict (arrays, e.g. a ``repro.models``
    init; nested dicts are followed) as the port's: same names and
    layouts, float32 tensors on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    return {k: load_jax_params(v, dev) if isinstance(v, dict) else
            torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
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


# ---------------------------------------------------------------------------
# SqueezeNet-style (fire modules: squeeze 1x1 -> expand 1x1/3x3)
# ---------------------------------------------------------------------------

def init_squeezenet(seed: int = 0, n_classes: int = 10, width: int = 16,
                    device=None) -> dict:
    g = _generator(seed)
    p = {"stem": _conv_init(g, 2 * width, 3, 3, 3),
         "stem_b": torch.zeros(2 * width)}
    c = 2 * width
    for i in range(3):
        sq, ex = width * (i + 1), 2 * width * (i + 1)
        p[f"f{i}_s"] = _conv_init(g, sq, c, 1, 1)
        p[f"f{i}_e1"] = _conv_init(g, ex, sq, 1, 1)
        p[f"f{i}_e3"] = _conv_init(g, ex, sq, 3, 3)
        c = 2 * ex
    p["head"] = _lin_init(g, c, n_classes)
    p["head_b"] = torch.zeros(n_classes)
    return _to(p, device)


def squeezenet_forward(p: dict, x: torch.Tensor,
                       acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    pool = lambda t: F.max_pool2d(t, 2, 2)
    x = pool(conv2d_block(x, p["stem"], p["stem_b"], acfg=acfg,
                          activation=torch.relu))
    for i in range(3):
        s = conv2d_block(x, p[f"f{i}_s"], None, padding="VALID", acfg=acfg,
                         activation=torch.relu)
        e1 = conv2d_block(s, p[f"f{i}_e1"], None, padding="VALID",
                          acfg=acfg, activation=torch.relu)
        e3 = conv2d_block(s, p[f"f{i}_e3"], None, acfg=acfg,
                          activation=torch.relu)
        x = torch.cat([e1, e3], dim=1)
        if i < 2:
            x = pool(x)
    x = x.mean(dim=(2, 3))
    return approx_dense(x, p["head"], p["head_b"], acfg)


# ---------------------------------------------------------------------------
# VAE (MNIST-style 28x28) and GAN (Fashion-MNIST-style): MLP variants
# ---------------------------------------------------------------------------

def init_vae(seed: int = 0, d_in: int = 784, d_h: int = 256, d_z: int = 32,
             device=None) -> dict:
    g = _generator(seed)
    return _to({
        "enc1": _lin_init(g, d_in, d_h), "enc1_b": torch.zeros(d_h),
        "mu": _lin_init(g, d_h, d_z), "mu_b": torch.zeros(d_z),
        "logvar": _lin_init(g, d_h, d_z), "logvar_b": torch.zeros(d_z),
        "dec1": _lin_init(g, d_z, d_h), "dec1_b": torch.zeros(d_h),
        "dec2": _lin_init(g, d_h, d_in), "dec2_b": torch.zeros(d_in),
    }, device)


def vae_forward(p: dict, x: torch.Tensor, noise,
                acfg: Optional[ApproxConfig] = None):
    """Returns ``(recon, mu, logvar)``. ``noise`` is the reparameterisation
    draw ``eps`` (a tensor of ``mu``'s shape) or a ``torch.Generator`` on
    ``x``'s device to draw it from (the reference draws it from a
    ``jax.random`` key, whose numbers a generator does not give)."""
    h = torch.relu(approx_dense(x, p["enc1"], p["enc1_b"], acfg))
    mu = approx_dense(h, p["mu"], p["mu_b"], acfg)
    logvar = approx_dense(h, p["logvar"], p["logvar_b"], acfg)
    if isinstance(noise, torch.Generator):
        eps = torch.randn(mu.shape, generator=noise, device=mu.device)
    else:
        eps = torch.as_tensor(noise, dtype=mu.dtype, device=mu.device)
    z = mu + torch.exp(0.5 * logvar) * eps
    h = torch.relu(approx_dense(z, p["dec1"], p["dec1_b"], acfg))
    recon = torch.sigmoid(approx_dense(h, p["dec2"], p["dec2_b"], acfg))
    return recon, mu, logvar


def vae_loss(p: dict, x: torch.Tensor, noise, acfg=None) -> torch.Tensor:
    recon, mu, logvar = vae_forward(p, x, noise, acfg)
    bce = -(x * torch.log(recon + 1e-7) +
            (1 - x) * torch.log(1 - recon + 1e-7)).sum(-1).mean()
    kl = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(-1).mean()
    return bce + kl


def init_gan(seed: int = 0, d_z: int = 64, d_h: int = 256, d_out: int = 784,
             device=None) -> dict:
    g = _generator(seed)
    return _to({
        "g1": _lin_init(g, d_z, d_h), "g1_b": torch.zeros(d_h),
        "g2": _lin_init(g, d_h, d_out), "g2_b": torch.zeros(d_out),
        "d1": _lin_init(g, d_out, d_h), "d1_b": torch.zeros(d_h),
        "d2": _lin_init(g, d_h, 1), "d2_b": torch.zeros(1),
    }, device)


def gan_generator(p: dict, z: torch.Tensor,
                  acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    h = torch.relu(approx_dense(z, p["g1"], p["g1_b"], acfg))
    return torch.sigmoid(approx_dense(h, p["g2"], p["g2_b"], acfg))


def gan_discriminator(p: dict, x: torch.Tensor,
                      acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    h = F.leaky_relu(approx_dense(x, p["d1"], p["d1_b"], acfg), 0.2)
    return approx_dense(h, p["d2"], p["d2_b"], acfg)
