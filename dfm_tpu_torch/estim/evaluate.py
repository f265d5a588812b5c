"""Pseudo out-of-sample forecast evaluation.

The port's twin of ``dfm_tpu.estim.evaluate``: re-fit on each window's
training rows, forecast h steps ahead, collect the errors at
t0 + h - 1 and compare them with naive benchmarks.  Two engines:

- ``engine="loop"``: one ``fit()`` per window.  With ``warm_start`` each
  window starts from the previous window's fitted params instead of a
  cold PCA init.
- ``engine="batched"`` (rolling windows only): every window in one
  ``fit_many``; with ``warm_start`` the first window is fitted once and
  its params seed every window.

``backend`` is a ``TorchBackend`` (None for CUDA), passed to ``fit`` and
to ``fit_many`` alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..api import DynamicFactorModel, fit, forecast
from ..backends import cpu_ref
from ..ops.precision import highest_precision
from .batched import DFMBatchSpec, fit_many
from .score import forecast_origin_errors

__all__ = ["oos_evaluate", "OOSResult"]


@dataclasses.dataclass
class OOSResult:
    origins: np.ndarray        # (W,) forecast origins t0 (exclusive end)
    errors: np.ndarray         # (W, N) forecast errors at horizon h
    rmse: np.ndarray           # (N,) per-series RMSE
    rmse_naive: np.ndarray     # (N,) RMSE of the last-value benchmark
    rmse_mean: np.ndarray      # (N,) RMSE of the in-sample-mean benchmark
    horizon: int

    @property
    def rel_rmse(self) -> np.ndarray:
        """RMSE relative to the naive last-value forecast (< 1: better)."""
        return self.rmse / np.maximum(self.rmse_naive, 1e-300)


def oos_evaluate(model: DynamicFactorModel, Y: np.ndarray,
                 horizon: int = 1,
                 n_windows: int = 20,
                 min_train: Optional[int] = None,
                 window: str = "rolling",
                 backend=None,
                 max_iters: int = 20,
                 origins: Optional[Sequence[int]] = None,
                 warm_start: bool = True,
                 engine: str = "loop") -> OOSResult:
    """Pseudo-OOS evaluation of h-step DFM forecasts.

    window: "rolling" keeps the train length fixed at ``min_train``;
    "expanding" grows it (loop engine only).  warm_start: start each
    window's EM from the previous window's params (loop) or from the
    first window's (batched).  engine: "loop" | "batched".
    """
    Y = np.asarray(Y, np.float64)
    T, N = Y.shape
    if min_train is None:
        min_train = max(40, T // 2)
    if origins is None:
        last = T - horizon
        origins = np.unique(np.linspace(min_train, last, n_windows,
                                        dtype=int))
    else:
        origins = np.asarray(list(origins), dtype=int)
    if engine not in ("loop", "batched"):
        raise ValueError(f"unknown engine {engine!r} (loop|batched)")
    run = (_batched_window_forecasts if engine == "batched"
           else _looped_window_forecasts)
    with highest_precision():
        y_hats = run(model, Y, origins, min_train, window, backend,
                     max_iters, horizon, warm_start)
    errors, naive, meanb = forecast_origin_errors(
        Y, origins, y_hats, min_train, window, horizon)
    rmse = np.sqrt((errors ** 2).mean(0))
    return OOSResult(origins=np.asarray(origins), errors=errors, rmse=rmse,
                     rmse_naive=np.sqrt((naive ** 2).mean(0)),
                     rmse_mean=np.sqrt((meanb ** 2).mean(0)),
                     horizon=horizon)


def _looped_window_forecasts(model, Y, origins, min_train, window, backend,
                             max_iters, horizon, warm_start):
    """One fit() per window; warm_start chains inits window to window."""
    y_hats = []
    prev = None
    for t0 in origins:
        lo = max(0, t0 - min_train) if window == "rolling" else 0
        init = prev.params if (warm_start and prev is not None) else None
        res = fit(model, Y[lo:t0], backend=backend, max_iters=max_iters,
                  init=init)
        y_hat, _ = forecast(res, horizon)
        y_hats.append(y_hat[-1])
        prev = res
    return y_hats


def _batched_window_forecasts(model, Y, origins, min_train, window, backend,
                              max_iters, horizon, warm_start):
    """Every window in one fit_many (rolling only)."""
    if window != "rolling":
        raise ValueError(
            "engine='batched' needs same-shaped windows; use "
            "window='rolling' (expanding windows change T per window)")
    if (np.asarray(origins) < min_train).any():
        raise ValueError("engine='batched' needs origins >= min_train "
                         "(every window must have the full train length)")
    spec = DFMBatchSpec.rolling_windows(model, Y, origins,
                                        train_len=min_train)
    if warm_start:
        t0 = int(origins[0])
        first = fit(model, Y[t0 - min_train:t0], backend=backend,
                    max_iters=max_iters)
        spec.inits = [first.params] * len(origins)
    res = fit_many(spec, backend=backend, max_iters=max_iters)
    y_hats = []
    for w in range(len(origins)):
        _, y, _ = cpu_ref.forecast(res.params[w], res.factors[w][-1],
                                   res.factor_cov[w][-1], horizon)
        if res.standardizers[w] is not None:
            y = res.standardizers[w].inverse(y)
        y_hats.append(y[-1])
    return y_hats
