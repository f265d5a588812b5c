"""Steady-state accelerated Kalman filter/smoother (twin of
``dfm_tpu.ssm.steady``).

For a time-invariant, fully observed panel the covariance recursion does
not depend on the data and converges geometrically, so ``tau`` exact
steps stand in for all T: the covariances, gains and log-determinants
freeze at their step-tau values, and the mean recursions become affine
scans with an exact head and a constant tail.  Sequential depth drops
from 2T to ~3 tau plus the scans.  Masked panels, ``tau < 1`` and
T <= 2 tau + 4 fall back to the exact info-form pair.

Two kernels carry it on CUDA tensors, each with its plain twin beside it
(the wrapper takes the twin only for CPU tensors):

- K5a ``ss_cov_path`` (``csrc/ss_cov_path.cu``): the tau forward
  covariance steps, the gains J_t and the two backward passes of the
  smoothed covariance, in one launch;
- K5b ``ops.scan.affine_scan`` (``csrc/affine_scan.cu``): the filtered
  means forward and the smoothed means in reverse;

each with a wide kernel for 16 < k <= 32 and a generic one for 32 < k
<= 128 (``kernels.route``; past 128 a CUDA call raises).

Exactness: not bit-exact against the exact pair; the freeze error decays
like rho(closed loop)^(2 tau), and ``delta`` (the relative change of the
last predicted-covariance step) reports it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..ops.linalg import chol_logdet, chol_solve, psd_cholesky, sym
from ..ops.precision import accum_dtype
from ..ops.scan import affine_scan
from .info_filter import (info_filter, loglik_from_terms, obs_stats,
                          quad_expanded, quad_local, u_from_stats)
from .kalman import rts_smoother
from .params import FilterResult, SmootherResult, SSMParams

__all__ = ["DEFAULT_TAU", "riccati_mixing_steps", "auto_tau",
           "remeasure_tau", "ss_cov_path", "ss_cov_path_plain",
           "ss_from_stats", "ss_filter_smoother", "ss_filter",
           "ss_smoother"]

DEFAULT_TAU = 96


def riccati_mixing_steps(p, tol: float = 1e-12, max_steps: int = 512) -> int:
    """Steps until the predicted-covariance recursion stops moving.

    Host NumPy f64 (k x k a step): the Riccati path P -> A (P^{-1} + C)^{-1}
    A' + Q is data-independent, so its mixing time sizes ``tau``.  ``p`` is
    any params object with Lam/A/Q/R/P0.
    """
    Lam = np.asarray(p.Lam, np.float64)
    A = np.asarray(p.A, np.float64)
    Q = np.asarray(p.Q, np.float64)
    C = (Lam / np.asarray(p.R, np.float64)[:, None]).T @ Lam
    k = A.shape[0]
    P = np.asarray(p.P0, np.float64)
    for t in range(1, max_steps + 1):
        Pf = np.linalg.solve(np.eye(k) + P @ C, P)
        Pn = A @ (0.5 * (Pf + Pf.T)) @ A.T + Q
        if np.max(np.abs(Pn - P)) <= tol * max(np.max(np.abs(Pn)), 1e-30):
            return t
        P = Pn
    return max_steps


def auto_tau(p, margin: float = 2.0, lo: int = 8, hi: int = 192) -> int:
    """``margin`` x the measured mixing time at ``p``, bucketed to the
    same powers-of-two-ish values as the JAX package."""
    tau = margin * riccati_mixing_steps(p)
    for b in (8, 12, 16, 24, 32, 48, 64, 96, 128, 192):
        if b >= lo and tau <= b:
            return int(min(b, hi))
    return hi


def remeasure_tau(p, current_tau: int, margin: float = 2.0,
                  hi: int = 192) -> int:
    """Re-size ``tau`` at the current params; never below ``current_tau``
    (equal means a longer horizon cannot help)."""
    return max(int(current_tau),
               auto_tau(p, margin=margin, lo=int(current_tau), hi=hi))


def _cov_path(C, A, Q, P0, tau: int):
    """tau exact covariance steps: (P_pred, P_filt, M = A - P_f C A,
    log|G|) stacked, and the freeze diagnostic delta."""
    k = A.shape[0]
    I_k = torch.eye(k, dtype=A.dtype, device=A.device)
    CA = C @ A
    P = P0
    out = [[], [], [], []]
    for _ in range(tau):
        Lp = psd_cholesky(P)
        G = I_k + Lp.T @ (C @ Lp)
        Lg = psd_cholesky(G, jitter=0.0)
        P_f = sym(Lp @ chol_solve(Lg, Lp.T))
        for lst, v in zip(out, (P, P_f, A - P_f @ CA, chol_logdet(Lg))):
            lst.append(v)
        P = sym(A @ P_f @ A.T + Q)
    Pp, Pf, M, ldG = (torch.stack(v) for v in out)
    delta = (P - Pp[-1]).abs().max() / (P.abs().max() + 1e-30)
    return Pp, Pf, M, ldG, delta


def ss_cov_path_plain(C, A, Q, P0, tau: int):
    """Plain twin of ``ss_cov_path``."""
    Pp, Pf, M, ldG, delta = _cov_path(C, A, Q, P0, tau)
    nxt = torch.cat([Pp[1:], Pp[-1:]], dim=0)        # P_pred at min(t+1, tau-1)
    J = chol_solve(psd_cholesky(nxt), A @ Pf).transpose(-1, -2)
    J_ss, Pp_ss, Pf_ss = J[-1], Pp[-1], Pf[-1]
    Ps, end_rev = Pf_ss, []
    for _ in range(tau):
        Ps = sym(Pf_ss + J_ss @ (Ps - Pp_ss) @ J_ss.T)
        end_rev.append(Ps)
    front = [None] * tau
    for t in reversed(range(tau)):
        Ps = sym(Pf[t] + J[t] @ (Ps - nxt[t]) @ J[t].T)
        front[t] = Ps
    return (Pp, Pf, M, ldG, delta, J, torch.stack(front),
            torch.stack(end_rev))


def ss_cov_path(C: torch.Tensor, A: torch.Tensor, Q: torch.Tensor,
                P0: torch.Tensor, tau: int):
    """The k x k part of the steady-state pass from the time-invariant C.

    Returns (P_pred, P_filt, M, log|G|) of the tau exact steps, the freeze
    diagnostic delta (0-d), the gains J (tau, k, k) (J_t for t < tau - 1
    and J_ss last), and the two backward smoothed-covariance passes:
    Psm_front (tau, k, k) at t = 0 .. tau-1 and Psm_end_rev (tau, k, k)
    in step order from the end (its last entry is the interior fixed
    point).  Kernel K5a for CUDA tensors (K5a-wide for 16 < k <= 32,
    K5a-gen for 32 < k <= 128, with a (5, k, k) workspace).
    """
    if C.device.type == "cpu":
        return ss_cov_path_plain(C, A, Q, P0, tau)
    k = A.shape[0]
    dt, dev = A.dtype, A.device
    kernel = kernels.route("ss_cov_path", k)
    if tau < 1:
        raise ValueError(f"ss_cov_path: tau = {tau} < 1")
    for name, x in (("C", C), ("A", A), ("Q", Q), ("P0", P0)):
        kernels.check_tensor(name, x, (k, k), dt, dev)
    mats = [torch.empty((tau, k, k), dtype=dt, device=dev) for _ in range(6)]
    ldG = torch.empty((tau,), dtype=dt, device=dev)
    delta = torch.empty((1,), dtype=dt, device=dev)
    Pp, Pf, M, J, front, end_rev = mats
    work = ((torch.empty((5, k, k), dtype=dt, device=dev),)
            if kernel == kernels.GEN["ss_cov_path"] else ())
    kernels.launch(kernel, dt, C, A, Q, P0, Pp, Pf, M, ldG, delta, J,
                   front, end_rev, *work, tau, k)
    return Pp, Pf, M, ldG, delta[0], J, front, end_rev


def _freeze(path: torch.Tensor, T: int, tau: int) -> torch.Tensor:
    """The exact first tau entries, then the step-tau value."""
    tail = path[-1].expand((T - tau,) + path.shape[1:])
    return torch.cat([path, tail], dim=0)


def ss_from_stats(stats, p: SSMParams, T: int, tau: int):
    """The k x k steady-state pass from the observation stats (C static).

    Returns (x_pred, P_pred, x_filt, P_filt, logdetG, SmootherResult,
    delta); the innovation quadratic of the loglik is the caller's.
    """
    k = p.A.shape[0]
    C, b = stats.C, stats.b
    Pp_ex, Pf_ex, M_ex, ldG_ex, delta, J_all, Psm_front, Psm_end_rev = \
        ss_cov_path(C, p.A, p.Q, p.P0, tau)
    P_pred = _freeze(Pp_ex, T, tau)
    P_filt = _freeze(Pf_ex, T, tau)
    logdetG = _freeze(ldG_ex, T, tau)

    # Filtered means: x_f[t] = M_t x_f[t-1] + P_f[t] b_t, M_t exact for
    # t < tau and frozen after (row 0 of d is not read).
    x0 = p.mu0 + Pf_ex[0] @ (b[0] - C @ p.mu0)
    d = torch.einsum("tkl,tl->tk", P_filt, b).contiguous()
    x_filt = affine_scan(d, M_ex, M_ex[-1], x0)
    x_pred = torch.cat([p.mu0[None], x_filt[:-1] @ p.A.T], dim=0)

    # Smoother: gains exact for t < tau - 1 and J_ss after; covariances
    # [front (tau), interior fixed point, end (tau), P_f at T-1].
    J = torch.cat([J_all[:-1], J_all[-1].expand(T - tau, k, k)], dim=0)
    P_sm = torch.cat([Psm_front,
                      Psm_end_rev[-1].expand(T - 1 - 2 * tau, k, k),
                      Psm_end_rev.flip(0), Pf_ex[-1][None]], dim=0)
    c = x_filt[:-1] - torch.einsum("tkl,tl->tk", J, x_pred[1:])
    c = torch.cat([c, torch.zeros_like(c[:1])], dim=0)
    x_sm = affine_scan(c, J_all[:-1], J_all[-1], x_filt[-1], reverse=True)
    P_lag = torch.cat([torch.zeros_like(P_sm[:1]),
                       torch.einsum("tij,tkj->tik", P_sm[1:], J)], dim=0)
    return (x_pred, P_pred, x_filt, P_filt, logdetG,
            SmootherResult(x_sm, P_sm, P_lag), delta)


def ss_filter_smoother(Y: torch.Tensor, p: SSMParams, tau: int = DEFAULT_TAU,
                       mask: Optional[torch.Tensor] = None, sumsq=None):
    """Filter + smoother with steady-state acceleration: (FilterResult,
    SmootherResult, delta).  Masked panels, tau < 1 and T <= 2 tau + 4
    run the exact info-form pair (delta = 0).

    ``sumsq``: the data-constant Y*Y; given with a compute dtype below the
    f64 accumulator, the loglik quadratic takes the expanded form
    (``quad_expanded``), else the residual pass (K1).
    """
    T = Y.shape[0]
    tau = int(tau)
    if mask is not None or tau < 1 or T <= 2 * tau + 4:
        kf = info_filter(Y, p, mask=mask)
        return kf, rts_smoother(kf, p), torch.zeros((), dtype=Y.dtype,
                                                    device=Y.device)
    p = p.to(dtype=Y.dtype)
    stats = obs_stats(Y, p.Lam, p.R)
    x_pred, P_pred, x_filt, P_filt, logdetG, sm, delta = ss_from_stats(
        stats, p, T, tau)
    if sumsq is not None and accum_dtype() != Y.dtype:
        quad_R = quad_expanded(sumsq, 1.0 / p.R, stats, x_pred)
    else:
        quad_R = quad_local(Y, p.Lam, p.R, x_pred)
    ll = loglik_from_terms(stats, logdetG, P_filt, quad_R,
                           u_from_stats(stats, x_pred))
    return FilterResult(x_pred, P_pred, x_filt, P_filt, ll), sm, delta


def ss_filter(Y, p, mask=None, tau: int = DEFAULT_TAU) -> FilterResult:
    return ss_filter_smoother(Y, p, tau=tau, mask=mask)[0]


def ss_smoother(Y, p, mask=None, tau: int = DEFAULT_TAU) -> SmootherResult:
    return ss_filter_smoother(Y, p, tau=tau, mask=mask)[1]
