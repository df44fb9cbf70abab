"""Batched image-inference serving (port of
``repro.serve.engine.VisionServeEngine``; the LM engines wait)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


class VisionServeEngine:
    """Fixed-size waves of ``slots`` images through one forward.

    ``forward_fn(params, images, acfg) -> logits`` is any vision forward
    (``repro_torch.models.vision.cnn_forward`` / ``resnet_forward``); every
    conv in it resolves a :func:`~repro_torch.core.acu.conv_plan`, so with
    a fused LUT ``acfg`` on the card the whole stack runs the fused CUDA
    kernels. Waves run under ``torch.inference_mode()`` on ``device``
    (``cuda`` unless given; ``params`` must already live there).
    """

    def __init__(self, params, forward_fn: Callable, *, slots: int = 8,
                 acfg=None, device=None):
        self.params = params
        self.slots = slots
        self.acfg = acfg
        self.device = resolve_device(device)
        self._forward = forward_fn

    def plan_report(self, image_shape, w_shape, acfg, **geom) -> dict:
        """The conv route one layer takes (see
        :func:`repro_torch.core.approx_ops.conv_plan_report`)."""
        from repro_torch.core.approx_ops import conv_plan_report
        return conv_plan_report(image_shape, w_shape, acfg, **geom)

    def run(self, images: np.ndarray) -> np.ndarray:
        """images: (B, C, H, W) -> logits (B, n_classes), served in waves
        of ``slots`` (the last wave zero-padded and sliced)."""
        b = images.shape[0]
        outs = []
        for i in range(0, b, self.slots):
            wave = np.asarray(images[i:i + self.slots], np.float32)
            pad = self.slots - wave.shape[0]
            if pad:
                wave = np.concatenate(
                    [wave, np.zeros((pad, *wave.shape[1:]), wave.dtype)])
            x = torch.from_numpy(wave).to(self.device)
            with torch.inference_mode():
                logits = self._forward(self.params, x, self.acfg)
            outs.append(logits.cpu().numpy()[:self.slots - pad])
        return np.concatenate(outs, axis=0)
