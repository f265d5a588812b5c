"""Likelihood-based factor-count selection on the batched engine.

The port's twin of ``dfm_tpu.estim.select.select_n_factors_em`` (and its
``EMSelectResult``).  The NumPy helpers of the JAX module
(``bai_ng_ic``, ``lasso_path``, ``targeted_predictors``) are not ported
yet (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..ops.precision import highest_precision
from .batched import DFMBatchSpec, fit_many

__all__ = ["EMSelectResult", "select_n_factors_em"]


@dataclasses.dataclass
class EMSelectResult:
    """Likelihood-based factor-count selection over a k-grid."""

    ks: np.ndarray           # (G,) candidate factor counts
    logliks: np.ndarray      # (G,) final EM loglik per k
    ic: np.ndarray           # (G,) criterion values (lower is better)
    k_best: int
    fit: object              # the underlying estim.batched.BatchFitResult


def select_n_factors_em(Y: np.ndarray, k_max: int = 8,
                        ks: Optional[np.ndarray] = None,
                        criterion: str = "bic", dynamics: str = "ar1",
                        max_iters: int = 30, tol: float = 1e-6,
                        backend=None, **fit_kw) -> EMSelectResult:
    """Choose k by penalized EM log-likelihood, every candidate in one
    batched fit.

    The grid members are padded to k_max with inert factors and fitted
    together by ``fit_many`` (``backend`` a ``TorchBackend``, None for
    CUDA; ``fit_kw`` go to ``fit_many``).  criterion: "bic" (penalty
    n_params * log(T*N)) or "aic" (2 * n_params); n_params counts Lam
    (N*k), R (N) and, for AR(1) dynamics, A (k^2) and Q (k(k+1)/2).
    Returns the whole ``BatchFitResult`` so the winning fit needs no
    refit.
    """
    Y = np.asarray(Y, np.float64)
    T, N = Y.shape
    if ks is None:
        ks = np.arange(1, int(k_max) + 1)
    ks = np.asarray(sorted(int(k) for k in ks), np.int64)
    spec = DFMBatchSpec.k_grid(Y, ks, dynamics=dynamics)
    with highest_precision():
        res = fit_many(spec, backend=backend, max_iters=max_iters, tol=tol,
                       **fit_kw)
    lls = res.logliks_final
    n_par = N * ks + N + (ks ** 2 + ks * (ks + 1) // 2
                          if dynamics == "ar1" else 0)
    if criterion == "bic":
        ic = -2.0 * lls + n_par * np.log(T * N)
    elif criterion == "aic":
        ic = -2.0 * lls + 2.0 * n_par
    else:
        raise ValueError(f"unknown criterion {criterion!r} (bic|aic)")
    return EMSelectResult(ks=ks, logliks=lls, ic=ic,
                          k_best=int(ks[np.argmin(ic)]), fit=res)
