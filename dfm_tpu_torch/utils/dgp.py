"""Factor-model data-generating process (a copy of ``dfm_tpu.utils.dgp``).

Draw loadings, simulate a stable factor VAR(1) path, add idiosyncratic
noise; ``simulate_tv_loadings`` draws the random-walk-loadings panel of the
time-varying-loadings family (config S4), ``simulate_mixed_freq`` the
monthly/quarterly panel of the mixed-frequency family (config S3),
``simulate_sv`` the stochastic-volatility panel (config S5).
Deterministic given the NumPy generator, so the same seed gives the same
panel as the JAX package's copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..backends.cpu_ref import SSMParams, _solve_discrete_lyapunov_or_eye

__all__ = ["dfm_params", "simulate", "simulate_tv_loadings", "random_mask",
           "mixed_freq_mask", "simulate_mixed_freq", "simulate_sv"]


def stable_var1(k: int, rng: np.random.Generator,
                spectral_radius: float = 0.7) -> np.ndarray:
    """Random k x k transition with spectral radius scaled to the target."""
    A = rng.standard_normal((k, k))
    ev = np.max(np.abs(np.linalg.eigvals(A)))
    return A * (spectral_radius / max(ev, 1e-12))


def dfm_params(N: int, k: int, rng: np.random.Generator,
               static: bool = False,
               noise_scale: float = 1.0,
               spectral_radius: float = 0.7) -> SSMParams:
    """Draw a random, identifiable-ish parameter set."""
    Lam = rng.standard_normal((N, k))
    if static:
        A = np.zeros((k, k))
        Q = np.eye(k)
    else:
        A = stable_var1(k, rng, spectral_radius)
        Q = np.eye(k)
    R = noise_scale * (0.5 + rng.random(N))      # heteroskedastic diag
    mu0 = np.zeros(k)
    P0 = _solve_discrete_lyapunov_or_eye(A, Q)
    return SSMParams(Lam, A, Q, R, mu0, P0)


def simulate(p: SSMParams, T: int, rng: np.random.Generator
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate (Y (T,N), F (T,k)) from the state-space model."""
    N, k = p.Lam.shape
    Lq = np.linalg.cholesky(p.Q + 1e-12 * np.eye(k))
    L0 = np.linalg.cholesky(p.P0 + 1e-12 * np.eye(k))
    F = np.zeros((T, k))
    f = p.mu0 + L0 @ rng.standard_normal(k)
    for t in range(T):
        if t > 0:
            f = p.A @ F[t - 1] + Lq @ rng.standard_normal(k)
        F[t] = f
    E = rng.standard_normal((T, N)) * np.sqrt(p.R)
    Y = F @ p.Lam.T + E
    return Y, F


def simulate_tv_loadings(N: int, T: int, k: int, rng: np.random.Generator,
                         walk_scale: float = 0.02,
                         noise_scale: float = 1.0):
    """Random-walk-loadings DGP (config S4, BASELINE.json:10).

    lam_{i,t} = lam_{i,t-1} + walk_scale * xi,  y_t = Lam_t f_t + eps.
    Returns (Y, F, Lams (T,N,k), A (k,k), R (N,))."""
    A = stable_var1(k, rng)
    F = np.zeros((T, k))
    f = rng.standard_normal(k)
    for t in range(T):
        if t > 0:
            f = A @ F[t - 1] + rng.standard_normal(k)
        F[t] = f
    Lam0 = rng.standard_normal((N, k))
    steps = walk_scale * rng.standard_normal((T, N, k))
    steps[0] = 0.0
    Lams = Lam0[None] + np.cumsum(steps, axis=0)
    R = noise_scale * (0.5 + rng.random(N))
    Y = np.einsum("tnk,tk->tn", Lams, F) + rng.standard_normal((T, N)) * np.sqrt(R)
    return Y, F, Lams, A, R


def simulate_sv(N: int, T: int, k: int, rng: np.random.Generator,
                vol_walk_scale: float = 0.05):
    """Stochastic-volatility DGP (config S5, BASELINE.json:11).

    Factor innovation log-variances follow random walks:
        h_t = h_{t-1} + vol_walk_scale * xi,   Q_t = diag(exp(h_t)).
    Returns (Y, F, H (T,k), params-without-SV for RBPF init)."""
    A = stable_var1(k, rng)
    Lam = rng.standard_normal((N, k))
    R = 0.5 + rng.random(N)
    H = np.cumsum(np.r_[np.zeros((1, k)),
                        vol_walk_scale * rng.standard_normal((T - 1, k))], axis=0)
    F = np.zeros((T, k))
    f = rng.standard_normal(k)
    for t in range(T):
        if t > 0:
            f = A @ F[t - 1] + np.exp(0.5 * H[t]) * rng.standard_normal(k)
        F[t] = f
    Y = F @ Lam.T + rng.standard_normal((T, N)) * np.sqrt(R)
    p = SSMParams(Lam, A, np.eye(k), R, np.zeros(k), np.eye(k))
    return Y, F, H, p


def random_mask(T: int, N: int, rng: np.random.Generator,
                frac_missing: float = 0.1) -> np.ndarray:
    """{0,1} observation mask with i.i.d. missingness."""
    return (rng.random((T, N)) >= frac_missing).astype(np.float64)


def mixed_freq_mask(T: int, N: int, n_quarterly: int) -> np.ndarray:
    """Monthly/quarterly mask: last ``n_quarterly`` series observed every 3rd
    period only (months 3, 6, ... -> indices 2, 5, ...), per the
    Mariano-Murasawa setup of SURVEY.md section 3.4."""
    mask = np.ones((T, N))
    q = np.zeros(T)
    q[2::3] = 1.0
    mask[:, N - n_quarterly:] = q[:, None]
    return mask


def simulate_mixed_freq(n_monthly: int, n_quarterly: int, T: int, k: int,
                        rng: np.random.Generator,
                        weights=(1.0, 2.0, 3.0, 2.0, 1.0),
                        noise_scale: float = 1.0):
    """Mixed-frequency DGP (config S3, BASELINE.json:9; SURVEY.md section 3.4).

    Monthly series load on f_t; quarterly series load on the Mariano-Murasawa
    weighted lag combination g_t = sum_j w_j f_{t-j} (w = [1,2,3,2,1]/3) and
    are observed only at months 3, 6, ... (indices 2, 5, ...).

    Returns (Y (T, Nm+Nq) with NaN at unobserved, mask, F (T, k), truth dict).
    """
    wv = np.asarray(weights, np.float64) / 3.0
    L = len(wv)
    A = stable_var1(k, rng)
    F = np.zeros((T + L - 1, k))
    f = rng.standard_normal(k)
    for t in range(T + L - 1):
        if t > 0:
            f = A @ F[t - 1] + rng.standard_normal(k)
        F[t] = f
    Fw = F[L - 1:]                                 # aligned current factor
    G = sum(wv[j] * F[L - 1 - j: L - 1 - j + T] for j in range(L))
    Lam_m = rng.standard_normal((n_monthly, k))
    Lam_q = rng.standard_normal((n_quarterly, k))
    R = noise_scale * (0.5 + rng.random(n_monthly + n_quarterly))
    Ym = Fw @ Lam_m.T + rng.standard_normal((T, n_monthly)) * np.sqrt(
        R[:n_monthly])
    Yq = G @ Lam_q.T + rng.standard_normal((T, n_quarterly)) * np.sqrt(
        R[n_monthly:])
    Y = np.concatenate([Ym, Yq], axis=1)
    mask = mixed_freq_mask(T, n_monthly + n_quarterly, n_quarterly)
    Y = np.where(mask > 0, Y, np.nan)
    truth = {"Lam_m": Lam_m, "Lam_q": Lam_q, "A": A, "R": R, "G": G}
    return Y, mask, Fw, truth
