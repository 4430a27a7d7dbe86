"""Savitzky–Golay smoothing as a precomputed linear operator.

The reference smooths the returned action sequence on the HOST with
``scipy.signal.savgol_filter(..., mode='interp')`` every control step
(``mppi.py:256-263``), forcing a device->host->device round trip.  Savitzky–
Golay with fixed window/order/length is a linear map, so we precompute the full
[T, T] operator once and apply it on-device as a single matmul.
"""
from __future__ import annotations

import numpy as np


def savgol_matrix(n: int, window: int, order: int) -> np.ndarray:
    """[n, n] matrix S with ``savgol_filter(x) == S @ x`` (mode='interp').

    Interior rows use the standard centered least-squares coefficients; the
    first/last half-windows evaluate the polynomial fitted to the first/last
    full window (exactly scipy's 'interp' edge mode).
    """
    if window % 2 == 0:
        window -= 1  # reference enforces odd window (mppi.py:192-193)
    window = min(window, n if n % 2 == 1 else n - 1)
    if window <= order:
        return np.eye(n)
    hw = window // 2
    S = np.zeros((n, n))

    def poly_projector(positions: np.ndarray, eval_at: np.ndarray) -> np.ndarray:
        # rows: for each eval point, weights over the window samples
        A = np.vander(positions, order + 1, increasing=True)  # [w, order+1]
        coef = np.linalg.pinv(A)  # [order+1, w]
        E = np.vander(eval_at, order + 1, increasing=True)  # [m, order+1]
        return E @ coef  # [m, w]

    center_row = poly_projector(
        np.arange(-hw, hw + 1, dtype=np.float64), np.array([0.0])
    )[0]
    for i in range(hw, n - hw):
        S[i, i - hw : i + hw + 1] = center_row

    # Leading edge: fit polynomial on x[0:window], evaluate at 0..hw-1
    lead = poly_projector(
        np.arange(window, dtype=np.float64), np.arange(hw, dtype=np.float64)
    )
    S[:hw, :window] = lead
    # Trailing edge: fit on x[n-window:], evaluate at the last hw points
    trail = poly_projector(
        np.arange(window, dtype=np.float64),
        np.arange(window - hw, window, dtype=np.float64),
    )
    S[n - hw :, n - window :] = trail
    return S
