"""The port's evaluation metrics (utils/metrics.py) against the JAX
package's on the same arrays: equal values, and the orderings of
tests/test_draw_disc.py::test_simple_metrics."""
import numpy as np
import pytest

from control_gic_tpu.utils import metrics as jmetrics
from control_gic_tpu_torch.utils import metrics


def _pairs():
    rng = np.random.default_rng(31)
    a = rng.uniform(0, 1, (32, 32, 3))
    return {
        "equal": (a, a),
        "noise 0.1": (a, np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)),
        "noise 0.3": (a, np.clip(a + rng.normal(0, 0.3, a.shape), 0, 1)),
        "gray f32": (a[..., 0].astype(np.float32),
                     rng.uniform(0, 1, (32, 32)).astype(np.float32)),
        "uint8 range": (np.round(a * 255), np.round(a[::-1] * 255)),
    }


PAIRS = _pairs()


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("name", ["psnr", "l2", "ssim", "dssim"])
def test_metric_equals_jax(name, pair):
    a, b = PAIRS[pair]
    kw = {"data_range": 255.0} if pair == "uint8 range" and name != "l2" \
        else {}
    got = getattr(metrics, name)(a, b, **kw)
    want = getattr(jmetrics, name)(a, b, **kw)
    assert type(got) is type(want) and got == want


def test_metric_orderings():
    a, b = PAIRS["noise 0.1"]
    _, c = PAIRS["noise 0.3"]
    assert metrics.l2(a, a) == 0.0 and metrics.l2(a, b) > 0
    assert abs(metrics.ssim(a, a) - 1.0) < 1e-12
    assert abs(metrics.dssim(a, a)) < 1e-12
    assert 0.0 < metrics.ssim(a, b) < 1.0
    assert 0.0 < metrics.dssim(a, b) < 0.5
    assert metrics.dssim(a, c) > metrics.dssim(a, b)
