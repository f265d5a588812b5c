"""Information-form Kalman filter: the N-scalable path.

The PyTorch twin of ``dfm_tpu.ssm.info_filter``.  With diagonal R the
update touches the cross-section only through k-dimensional reductions

    C_t = Lam' W_t R^{-1} Lam   (k, k)     b_t = Lam' W_t R^{-1} y_t   (k,)
    n_t = #observed at t                   ldR_t = sum of log R over observed

and the time scan is pure k x k:

    P_f = (P_p^{-1} + C_t)^{-1} = L (I + L' C_t L)^{-1} L',  P_p = LL'
    x_f = x_p + P_f (b_t - C_t x_p)
    log|S_t| = ldR_t + log|I + L' C_t L|,   v'S^{-1}v = v'R^{-1}v - u'P_f u

The quadratic v'R^{-1}v comes from a second pass over the true residuals
(the expanded form cancels catastrophically in f32).

Four routines here are kernels on CUDA tensors, each with its plain
version beside it (the wrapper takes the plain version only for CPU
tensors): K2 ``obs_stats`` when masked (``csrc/obs_stats.cu``; the unmasked
statistics are a GEMM and stay ``torch.matmul``), K4-forward ``info_scan``
(``csrc/info_scan.cu``), K1 ``quad_local`` (``csrc/quad_local.cu``) and
``loglik_terms_local`` (quad_R and U from the residual).  The first three
launch their k <= 16 kernel, for 16 < k <= 32 their wide kernel (K12) and
for 32 < k <= 128 their generic kernel (``kernels.route``), and raise past
128; ``loglik_terms_local`` launches K1-wide at every k <= 32 and K1-gen
for 32 < k <= 128.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..ops.linalg import chol_logdet, chol_solve, psd_cholesky, sym
from ..ops.precision import accum_dtype, highest_precision
from .kalman import kalman_filter, rts_smoother
from .params import FilterResult, SSMParams

__all__ = ["ObsStats", "obs_stats", "obs_stats_plain", "info_scan",
           "info_scan_plain", "quad_local", "quad_local_plain",
           "loglik_terms_local", "loglik_terms_local_plain",
           "u_from_stats", "quad_expanded", "loglik_from_terms",
           "info_filter_from_stats",
           "info_filter", "loglik_eval", "smooth"]

_LOG2PI = 1.8378770664093453


class ObsStats(NamedTuple):
    """Per-step k-dimensional observation reductions.

    C is (k, k) when the mask is absent (time-invariant precision) and
    (T, k, k) when masked.
    """

    b: torch.Tensor     # (T, k)
    C: torch.Tensor     # (k, k) or (T, k, k)
    n: torch.Tensor     # (T,)
    ldR: torch.Tensor   # (T,)


def obs_stats_plain(Y, Lam, R, mask=None) -> ObsStats:
    """Plain-torch observation statistics (masked or not)."""
    T, N = Y.shape
    if mask is None:
        G = Lam / R[:, None]                        # R^{-1} Lam, (N, k)
        n = torch.full((T,), float(N), dtype=Y.dtype, device=Y.device)
        # The same N-sum repeats T times, so its rounding is systematic
        # across the loglik: the one sum accumulates in f64.
        ldR = torch.log(R).to(accum_dtype()).sum().expand(T).clone()
        return ObsStats(Y @ G, Lam.T @ G, n, ldR)
    W = mask.to(Y.dtype)
    Yw = W * torch.nan_to_num(Y)                    # masked entries may be NaN
    Rinv = 1.0 / R
    b = Yw @ (Lam * Rinv[:, None])
    C = torch.einsum("nk,tn,n,nl->tkl", Lam, W, Rinv, Lam).contiguous()
    n = W.sum(dim=1)
    ldR = W @ torch.log(R)
    return ObsStats(b, C, n, ldR)


def obs_stats(Y: torch.Tensor, Lam: torch.Tensor, R: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> ObsStats:
    """Reduce the panel to k-dimensional per-step statistics.

    Y (T, N), Lam (N, k), R (N,); mask optional (T, N) {0,1} in Y's dtype.
    Unmasked: torch.matmul.  Masked: kernel K2 for CUDA tensors (K2-wide
    for 16 < k <= 32, K2-gen for 32 < k <= 128).
    """
    if mask is None or Y.device.type == "cpu":
        return obs_stats_plain(Y, Lam, R, mask)
    T, N = Y.shape
    k = Lam.shape[1]
    dt, dev = Y.dtype, Y.device
    kernel = kernels.route("obs_stats", k)
    for name, x, shape in (("Y", Y, (T, N)), ("Lam", Lam, (N, k)),
                           ("R", R, (N,)), ("mask", mask, (T, N))):
        kernels.check_tensor(name, x, shape, dt, dev)
    b = torch.empty((T, k), dtype=dt, device=dev)
    C = torch.empty((T, k, k), dtype=dt, device=dev)
    n = torch.empty((T,), dtype=dt, device=dev)
    ldR = torch.empty((T,), dtype=dt, device=dev)
    kernels.launch(kernel, dt, Y, Lam, R, mask, b, C, n, ldR, T, N, k)
    return ObsStats(b, C, n, ldR)


def info_scan_plain(stats: ObsStats, A, Q, mu0, P0):
    """Plain-torch k x k time scan over the observation statistics.

    Returns (x_pred, P_pred, x_filt, P_filt, logdetG (T,)) with
    logdetG_t = log|I + L' C_t L|.
    """
    T, k = stats.b.shape
    I_k = torch.eye(k, dtype=stats.b.dtype, device=stats.b.device)
    x, P = mu0, P0
    out = [[], [], [], [], []]
    for t in range(T):
        C_t = stats.C if stats.C.ndim == 2 else stats.C[t]
        Lp = psd_cholesky(P)
        CL = C_t @ Lp
        G = I_k + Lp.T @ CL                         # >= I: chol needs no jitter
        Lg = psd_cholesky(G, jitter=0.0)
        P_f = sym(Lp @ chol_solve(Lg, Lp.T))
        u = stats.b[t] - C_t @ x
        x_f = x + P_f @ u
        for lst, v in zip(out, (x, P, x_f, P_f, chol_logdet(Lg))):
            lst.append(v)
        x = A @ x_f
        P = sym(A @ P_f @ A.T + Q)
    return tuple(torch.stack(v) for v in out)


def info_scan(stats: ObsStats, A, Q, mu0, P0):
    """The k x k time scan: kernel K4-forward for CUDA tensors (K4-wide
    for 16 < k <= 32, K4-gen for 32 < k <= 128, with a (4, k, k)
    workspace)."""
    b = stats.b
    if b.device.type == "cpu":
        return info_scan_plain(stats, A, Q, mu0, P0)
    T, k = b.shape
    dt, dev = b.dtype, b.device
    kernel = kernels.route("info_scan", k)
    static_C = stats.C.ndim == 2
    for name, x, shape in (("b", b, (T, k)),
                           ("C", stats.C, (k, k) if static_C else (T, k, k)),
                           ("A", A, (k, k)), ("Q", Q, (k, k)),
                           ("mu0", mu0, (k,)), ("P0", P0, (k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    x_pred = torch.empty((T, k), dtype=dt, device=dev)
    P_pred = torch.empty((T, k, k), dtype=dt, device=dev)
    x_filt = torch.empty((T, k), dtype=dt, device=dev)
    P_filt = torch.empty((T, k, k), dtype=dt, device=dev)
    logdetG = torch.empty((T,), dtype=dt, device=dev)
    work = (torch.empty((4, k, k), dtype=dt, device=dev),) \
        if kernel == kernels.GEN["info_scan"] else ()
    kernels.launch(kernel, dt, b, stats.C, 0 if static_C else k * k,
                   A, Q, mu0, P0, x_pred, P_pred, x_filt, P_filt, logdetG,
                   *work, T, k)
    return x_pred, P_pred, x_filt, P_filt, logdetG


def quad_local_plain(Y, Lam, R, x_pred, mask=None) -> torch.Tensor:
    """Plain-torch quad_R (T,) = sum_n w (y - lam_n . x_t)^2 / R_n in f64."""
    V = Y - x_pred @ Lam.T
    if mask is not None:
        V = mask.to(Y.dtype) * torch.nan_to_num(V)
    return (V * (V / R[None, :])).to(accum_dtype()).sum(dim=1)


def quad_local(Y: torch.Tensor, Lam: torch.Tensor, R: torch.Tensor,
               x_pred: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The innovation quadratic quad_R (T,), f64: kernel K1 for CUDA
    tensors (K1-wide, with no U, for 16 < k <= 32; K1-gen for 32 < k <=
    128).  (The JAX routine also
    returns the residual panel, which its caller drops; here it is never
    formed.)"""
    if Y.device.type == "cpu":
        return quad_local_plain(Y, Lam, R, x_pred, mask)
    T = Y.shape[0]
    kernel = kernels.route("quad_local", Lam.shape[1])
    out = torch.empty((T,), dtype=torch.float64, device=Y.device)
    if kernel == "quad_local":
        _quad_launch(kernel, Y, Lam, R, x_pred, mask, out)
    else:
        _quad_launch(kernel, Y, Lam, R, x_pred, mask, out, None)
    return out


def _quad_launch(kernel, Y, Lam, R, x_pred, mask, *outs) -> None:
    """Check the residual pass's inputs and launch ``kernel`` on them."""
    T, N = Y.shape
    k = Lam.shape[1]
    dt, dev = Y.dtype, Y.device
    checks = [("Y", Y, (T, N)), ("Lam", Lam, (N, k)), ("R", R, (N,)),
              ("x_pred", x_pred, (T, k))]
    if mask is not None:
        checks.append(("mask", mask, (T, N)))
    for name, x, shape in checks:
        kernels.check_tensor(name, x, shape, dt, dev)
    kernels.launch(kernel, dt, Y, Lam, R, x_pred, mask, *outs, T, N, k)


def loglik_terms_local_plain(Y, Lam, R, x_pred, mask=None):
    """Plain-torch residual pass: (quad_R (T,) f64, U (T, k)), v = y -
    lam_n . x_pred,t (masked: w nan_to_num(v)), U = sum_n (v / R_n) lam_n."""
    V = Y - x_pred @ Lam.T
    if mask is not None:
        V = mask.to(Y.dtype) * torch.nan_to_num(V)
    VR = V / R[None, :]
    return (V * VR).to(accum_dtype()).sum(dim=1), VR @ Lam


def loglik_terms_local(Y, Lam, R, x_pred, mask=None):
    """The innovation-quadratic reductions with U from the true residuals
    (the JAX function of this name; U = b - C x_pred only in exact
    arithmetic): kernel K1-wide for CUDA tensors at any k <= 32, K1-gen
    for 32 < k <= 128."""
    if Y.device.type == "cpu":
        return loglik_terms_local_plain(Y, Lam, R, x_pred, mask)
    T, k = x_pred.shape
    kernel = kernels.route("quad_local", k)
    if k <= kernels.WIDE_KMAX:          # K1 itself forms no U
        kernel = "quad_local_wide"
    quad = torch.empty((T,), dtype=torch.float64, device=Y.device)
    U = torch.empty((T, k), dtype=Y.dtype, device=Y.device)
    _quad_launch(kernel, Y, Lam, R, x_pred, mask, quad, U)
    return quad, U


def u_from_stats(stats: ObsStats, x_pred: torch.Tensor) -> torch.Tensor:
    """U (T, k) = Lam'R^{-1}v = b_t - C_t x_pred,t, with no panel pass."""
    if stats.C.ndim == 2:
        return stats.b - x_pred @ stats.C           # C symmetric
    return stats.b - torch.einsum("tkl,tl->tk", stats.C, x_pred)


def quad_expanded(sumsq: torch.Tensor, Rinv: torch.Tensor, stats: ObsStats,
                  x_pred: torch.Tensor) -> torch.Tensor:
    """v'R^{-1}v per step without a residual panel pass (unmasked only):
    sum_i y^2/R - 2 x_p.b + x_p'C x_p, with ``sumsq`` the data-constant
    Y*Y.  Each piece is cast to the f64 accumulator after its product,
    where the three (T,)-sized pieces cancel; only for a compute dtype
    below the accumulator (in f64 the residual pass ``quad_local`` runs).
    ``sumsq @ Rinv`` is a plain GEMV."""
    acc = accum_dtype()
    c2 = (sumsq @ Rinv).to(acc)
    xb = torch.einsum("tk,tk->t", x_pred, stats.b).to(acc)
    if stats.C.ndim == 2:
        xCx = torch.einsum("tk,kl,tl->t", x_pred, stats.C, x_pred)
    else:
        xCx = torch.einsum("tk,tkl,tl->t", x_pred, stats.C, x_pred)
    return c2 - 2.0 * xb + xCx.to(acc)


def loglik_from_terms(stats: ObsStats, logdetG, P_filt, quad_R, U):
    """Assemble sum_t ll_t.  The total is a ~100x smaller residual of
    cancelling O(N T) pieces, so the (T,)-sized assembly runs in f64; the
    U'P_f U contraction stays in the compute dtype."""
    acc = accum_dtype()
    upu = torch.einsum("tk,tkl,tl->t", U.to(P_filt.dtype), P_filt,
                       U.to(P_filt.dtype))
    quad = quad_R.to(acc) - upu.to(acc)
    lls = -0.5 * (stats.n.to(acc) * _LOG2PI + stats.ldR.to(acc)
                  + logdetG.to(acc) + quad)
    return lls.sum()


def info_filter_from_stats(stats: ObsStats, A, Q, mu0, P0, Y, Lam, R,
                           mask=None) -> FilterResult:
    """Scan + loglik in one call."""
    xp, Pp, xf, Pf, logdetG = info_scan(stats, A, Q, mu0, P0)
    quad_R = quad_local(Y, Lam, R, xp, mask)
    ll = loglik_from_terms(stats, logdetG, Pf, quad_R, u_from_stats(stats, xp))
    return FilterResult(xp, Pp, xf, Pf, ll)


def info_filter(Y: torch.Tensor, p: SSMParams,
                mask: Optional[torch.Tensor] = None) -> FilterResult:
    """Single-call info-form filter: stats + scan + residual loglik pass."""
    p = p.to(dtype=Y.dtype)
    stats = obs_stats(Y, p.Lam, p.R, mask=mask)
    return info_filter_from_stats(stats, p.A, p.Q, p.mu0, p.P0,
                                  Y=Y, Lam=p.Lam, R=p.R, mask=mask)


def loglik_eval(Y, p, mask=None, precise: bool = True,
                device=None) -> float:
    """Reporting-grade log-likelihood evaluation.

    ``precise=True`` re-evaluates the filter in float64 on the same device
    (the check of the 1e-5 loglik contract); ``precise=False`` evaluates in
    Y's dtype.  ``Y``, ``mask`` and ``p`` may be NumPy or tensors; the
    device is Y's when Y is a tensor, else ``device`` (default "cuda").
    """
    if isinstance(Y, torch.Tensor):
        dev = Y.device
        dtype = torch.float64 if precise else Y.dtype
    else:
        dev = torch.device(device or "cuda")
        dtype = torch.float64 if precise else torch.float32
    Yt = torch.as_tensor(Y, dtype=dtype, device=dev).contiguous()
    pt = SSMParams(*(torch.as_tensor(x, dtype=dtype, device=dev).contiguous()
                     for x in (p.Lam, p.A, p.Q, p.R, p.mu0, p.P0)))
    mt = (torch.as_tensor(mask, dtype=dtype, device=dev).contiguous()
          if mask is not None else None)
    with highest_precision():
        return float(info_filter(Yt, pt, mask=mt).loglik)


def smooth(Y: torch.Tensor, p: SSMParams, mask=None,
           dense: bool = False):
    """Filter + RTS smoother at ``p``; returns (x_sm, P_sm) on Y's device.
    ``dense`` uses the N x N filter (the small-N engine, kernel K15 on
    CUDA) instead of the information form."""
    kf = (kalman_filter if dense else info_filter)(Y, p, mask=mask)
    sm = rts_smoother(kf, p.to(dtype=Y.dtype))
    return sm.x_sm, sm.P_sm
