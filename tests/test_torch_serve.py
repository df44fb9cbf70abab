"""The port's data pipeline and vision serving engine on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ApproxConfig, make_acu  # noqa: E402
from repro_torch.data.pipeline import image_task  # noqa: E402
from repro_torch.models.vision import (init_cnn, init_resnet,  # noqa: E402
                                       load_jax_params, resnet_forward)
from repro_torch.serve.engine import VisionServeEngine  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402


def test_image_task_matches_reference():
    load_reference()
    from repro.data.pipeline import image_task as ref_task
    got = next(image_task(size=8, seed=3)(5, seed=4))
    want = next(ref_task(size=8, seed=3)(5, seed=4))
    for key in ("image", "label"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])


def test_init_shapes_match_reference():
    import jax
    load_reference()
    from repro.models import vision as jv
    for ours, theirs in (
            (init_resnet(0, width=4, n_blocks=2, device="cpu"),
             jv.init_resnet(jax.random.PRNGKey(0), width=4, n_blocks=2)),
            (init_cnn(0, width=4, img=8, device="cpu"),
             jv.init_cnn(jax.random.PRNGKey(0), width=4, img=8))):
        assert {k: tuple(v.shape) for k, v in ours.items()} == \
            {k: tuple(v.shape) for k, v in theirs.items()}
    params = jv.init_resnet(jax.random.PRNGKey(0), width=4, n_blocks=1)
    loaded = load_jax_params({k: np.asarray(v) for k, v in params.items()},
                             device="cpu")
    for k, v in params.items():
        assert loaded[k].dtype == torch.float32
        assert np.array_equal(loaded[k].numpy(), np.asarray(v))


def test_resnet20_parameter_count():
    p = init_resnet(0, device="cpu")        # width 16, 3 blocks: ResNet-20
    assert sum(v.numel() for v in p.values()) == 270_922


@pytest.mark.parametrize("fused", [False, True])
def test_engine_serves_waves(fused):
    acfg = ApproxConfig(acu=make_acu("mul8s_1L2H", "lut", use_kernels=True,
                                     fused=fused))
    params = init_resnet(0, width=4, n_blocks=1, device="cpu")
    images = next(image_task(size=8)(5))["image"]
    eng = VisionServeEngine(params, lambda p, x, a: resnet_forward(
        p, x, a, n_blocks=1), slots=2, acfg=acfg, device="cpu")
    out = eng.run(images)
    assert out.shape == (5, 10) and np.isfinite(out).all()
    # waves of 2; the last holds one image and one zero image
    with torch.inference_mode():
        waves = [resnet_forward(params, torch.from_numpy(w), acfg,
                                n_blocks=1).numpy()
                 for w in (images[0:2], images[2:4],
                           np.concatenate([images[4:5],
                                           np.zeros_like(images[4:5])]))]
    assert np.array_equal(out, np.concatenate(waves)[:5])
    rep = eng.plan_report((2, 3, 8, 8), (4, 3, 3, 3), acfg)
    assert rep["route"] == ("fused_conv" if fused else "im2col")
