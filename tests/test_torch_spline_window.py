"""Port parity: the spline against the JAX package's windowed Pallas kernel.

The port's plain spline (:func:`bspline_resample_fused` on the CPU) is
held to ``cubic_resample_fused`` run in interpret mode on the CPU, as
``tests/test_window_resample.py`` runs it, for orders 2-7, at that
file's tolerances: 2e-5 for orders 2-3 and 5e-5 for orders 4-7. The
kernel's own taps (closed forms for orders 2-3) and summation order
differ from the port's in rounding only.
"""

from __future__ import annotations

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from test_torch_bspline import SPLINE_ATOL, _port_spline, _spline_case
from torchio_tpu.ops.window_resample import cubic_resample_fused, cubic_window_eligible


@pytest.mark.parametrize("order", range(2, 8))
def test_spline_matches_jax_pallas_interpret(order, monkeypatch):
    monkeypatch.setenv("TORCHIO_TPU_WINDOW_INTERPRET", "1")
    data, ms, cps, fill = _spline_case(
        order, shape=(2, 1, 16, 16, 24), elastic=(True, True),
        angles=((0.01, 0.0, -0.01), (0.0, 0.012, 0.0)), amplitude=1.0,
    )
    pads = cubic_window_eligible(data.shape, data.shape[2:], ms, cps, order=order)
    assert pads is not None
    want = cubic_resample_fused(data, ms, cps, fill, padi=pads[0], padj=pads[1],
                                order=order)
    got = _port_spline(data, ms, cps, fill, order)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=SPLINE_ATOL[order])
