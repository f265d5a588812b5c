"""Forecast-error windowing of pseudo-out-of-sample evaluation (a copy).

The port's copy of ``forecast_origin_errors`` from
``dfm_tpu.estim.score`` (NumPy), the part ``estim.evaluate`` needs.  The
held-out one-step scorers of that module serve tuning and maintenance,
which are not ported yet (ROADMAP Queue 1 items 8 and 9).
"""

from __future__ import annotations

import numpy as np

__all__ = ["forecast_origin_errors"]


def forecast_origin_errors(Y: np.ndarray, origins, y_hats, min_train: int,
                           window: str, horizon: int):
    """Per-window forecast errors against the truth, and the naive
    benchmarks.

    Returns ``(errors, naive, meanb)``, each (W, N): the model's error,
    the last-value benchmark's error and the train-mean benchmark's error
    at each origin.
    """
    Y = np.asarray(Y, np.float64)
    N = Y.shape[1]
    errors = np.zeros((len(origins), N))
    naive = np.zeros((len(origins), N))
    meanb = np.zeros((len(origins), N))
    for w, t0 in enumerate(origins):
        lo = max(0, t0 - min_train) if window == "rolling" else 0
        Ytr = Y[lo:t0]
        truth = Y[t0 + horizon - 1]
        errors[w] = truth - y_hats[w]
        naive[w] = truth - Ytr[-1]
        meanb[w] = truth - Ytr.mean(0)
    return errors, naive, meanb
