"""Host-side NumPy float64 pieces that ``fit`` needs.

The port's own copy of part of ``dfm_tpu.backends.cpu_ref``: the NumPy
parameter container, the Stock-Watson PCA warm start with its VAR(1) tail,
the stationary-covariance helper and the h-step forecast.  The dense NumPy
Kalman/EM oracle itself stays in the JAX package, where the tests reach it.

Model:  y_t = Lam f_t + eps_t,  eps_t ~ N(0, diag(R));
        f_t = A f_{t-1} + eta_t,  eta_t ~ N(0, Q);  f_1 ~ N(mu0, P0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SSMParams", "pca_init", "pca_svd", "var_tail", "forecast"]


@dataclasses.dataclass
class SSMParams:
    """Dense state-space parameters in NumPy.

    Lam : (N, k) factor loadings
    A   : (k, k) factor VAR(1) transition (zero matrix for a static DFM)
    Q   : (k, k) state innovation covariance
    R   : (N,)   diagonal observation noise variances
    mu0 : (k,)   initial state mean
    P0  : (k, k) initial state covariance
    """

    Lam: np.ndarray
    A: np.ndarray
    Q: np.ndarray
    R: np.ndarray
    mu0: np.ndarray
    P0: np.ndarray

    def copy(self) -> "SSMParams":
        return SSMParams(*(np.array(getattr(self, f.name), dtype=np.float64)
                           for f in dataclasses.fields(self)))

    @property
    def n_series(self) -> int:
        return self.Lam.shape[0]

    @property
    def n_factors(self) -> int:
        return self.Lam.shape[1]


def _sym(M: np.ndarray) -> np.ndarray:
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def pca_init(Y: np.ndarray, k: int, static: bool = False,
             mask: Optional[np.ndarray] = None,
             Vt: Optional[np.ndarray] = None) -> SSMParams:
    """Stock-Watson principal-components initializer.

    ``Y`` is already standardized per series.  Lam = sqrt(N) * top-k right
    singular vectors of Y; f = Y Lam / N.  Then A, Q from an OLS VAR(1) on
    f and R from the idiosyncratic residual variances.  With ``static`` the
    dynamics are pinned to A = 0, Q = I.  Missing entries (mask = 0 or NaN)
    are zero-filled, the series mean of a standardized panel.  ``Vt``: the
    right singular vectors of that zero-filled Y when already computed
    (``pca_svd``; inits of one panel at several k share them).
    """
    Y = np.asarray(Y, dtype=np.float64)
    T, N = Y.shape
    if mask is not None:
        Y = np.where(np.asarray(mask) > 0, np.nan_to_num(Y), 0.0)
    if Vt is None:
        Vt = pca_svd(Y)
    V = Vt[:k].T                                  # (N, k) top eigvecs of Y'Y
    Lam = np.sqrt(N) * V
    F = Y @ Lam / N                               # (T, k)
    resid = Y - F @ Lam.T
    R = np.maximum(resid.var(axis=0), 1e-6)
    A, Q, mu0, P0 = var_tail(F, k, static)
    return SSMParams(Lam, A, Q, R, mu0, P0)


def pca_svd(Y: np.ndarray) -> np.ndarray:
    """The right singular vectors ``pca_init`` takes its loadings from
    (rows, largest singular value first), of a zero-filled panel."""
    return np.linalg.svd(np.asarray(Y, dtype=np.float64),
                         full_matrices=False)[2]


def var_tail(F: np.ndarray, k: int, static: bool = False):
    """The k-sized dynamics tail of the PCA init: OLS VAR(1) on the factor
    path + stationary P0.  Shared with the device-side initializer; the
    factor path is tiny, so this always runs on the host."""
    F = np.asarray(F, np.float64)
    if static:
        A = np.zeros((k, k))
        Q = np.eye(k)
    else:
        X, Z = F[1:], F[:-1]
        A = np.linalg.solve(Z.T @ Z + 1e-8 * np.eye(k), Z.T @ X).T
        eta = X - Z @ A.T
        Q = _sym(eta.T @ eta / max(len(eta) - 1, 1)) + 1e-8 * np.eye(k)
    mu0 = np.zeros(k)
    P0 = _solve_discrete_lyapunov_or_eye(A, Q)
    return A, Q, mu0, P0


_KRON_KMAX = 32     # the widest k whose P0 is the reference's Kronecker solve


def _solve_discrete_lyapunov_or_eye(A: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Stationary state covariance P = A P A' + Q, or I if A is not stable.

    To k = 32 the reference's k^2 x k^2 Kronecker solve vec(P) = (I - A
    kron A)^{-1} vec(Q), bit for bit; past 32, where that solve takes O(k^6)
    (a 2 GB matrix and ~30 s at k = 128), Smith's doubling iteration sums P
    = sum_j A^j Q A'^j in log2 steps of O(k^3) (P <- P + A_j P A_j', A_j <-
    A_j^2).  The two agree to rounding."""
    k = A.shape[0]
    eig = np.max(np.abs(np.linalg.eigvals(A))) if k else 0.0
    if eig >= 0.999:
        return np.eye(k)
    if k <= _KRON_KMAX:
        M = np.eye(k * k) - np.kron(A, A)
        return _sym(np.linalg.solve(M, Q.reshape(-1)).reshape(k, k))
    P, Aj = np.array(Q, np.float64), np.array(A, np.float64)
    for _ in range(64):
        step = Aj @ P @ Aj.T
        P = P + step
        if np.abs(step).max() <= np.finfo(np.float64).eps * np.abs(P).max():
            break
        Aj = Aj @ Aj
    return _sym(P)


def forecast(p: SSMParams, x_T: np.ndarray, P_T: np.ndarray, horizon: int):
    """h-step-ahead factor and observable forecasts.

    Returns (f_fore (h, k), y_fore (h, N), P_fore (h, k, k)).
    """
    k = p.n_factors
    f = np.zeros((horizon, k))
    P = np.zeros((horizon, k, k))
    x, V = np.asarray(x_T, np.float64), np.asarray(P_T, np.float64)
    A, Q = np.asarray(p.A, np.float64), np.asarray(p.Q, np.float64)
    for h in range(horizon):
        x = A @ x
        V = _sym(A @ V @ A.T + Q)
        f[h] = x
        P[h] = V
    y = f @ np.asarray(p.Lam, np.float64).T
    return f, y, P
