"""Time-series helpers.

Parity: reference `util/TimeSeriesUtils.java` and
`util/MovingWindowMatrix.java` — lagged matrices and sliding windows over
a sequence. Vectorized via stride tricks so downstream batching feeds the
device one contiguous array (no per-window Python loop).
"""

from __future__ import annotations

import numpy as np


def moving_window_matrix(x: np.ndarray, window: int,
                         add_rotate: bool = False) -> np.ndarray:
    """All contiguous windows of length `window` over flat x ->
    (n_windows, window). With add_rotate, also append the windows of the
    circularly-rotated sequence (`MovingWindowMatrix` parity)."""
    x = np.asarray(x).ravel()
    if window > len(x):
        raise ValueError(f"window {window} > sequence length {len(x)}")
    out = np.lib.stride_tricks.sliding_window_view(x, window).copy()
    if add_rotate:
        rot = np.roll(x, -1)
        out = np.vstack(
            [out, np.lib.stride_tricks.sliding_window_view(rot, window)])
    return out


def lagged(x: np.ndarray, lag: int) -> np.ndarray:
    """(T,) -> (T-lag, lag+1) matrix of [x_t, x_{t-1}, ..., x_{t-lag}]
    (`TimeSeriesUtils.getTimeSeries` style lag embedding)."""
    x = np.asarray(x).ravel()
    if lag >= len(x):
        raise ValueError(f"lag {lag} >= sequence length {len(x)}")
    win = np.lib.stride_tricks.sliding_window_view(x, lag + 1)
    return win[:, ::-1].copy()


def difference(x: np.ndarray, order: int = 1) -> np.ndarray:
    return np.diff(np.asarray(x).ravel(), n=order)
