"""Dense-covariance Kalman filter and the RTS smoother.

The PyTorch twin of ``dfm_tpu.ssm.kalman``.  ``kalman_filter`` is the
small-N engine (``filter="auto"`` picks it below N = 32: an N x N
innovation covariance a step): kernel K15 (``csrc/dense_filter.cu``, the
whole T-step chain in one launch, N <= 32 and k <= 32; past either, to N
= 128 and k = 128, K15-gen in ``csrc/gen_filters.cu``:
``kernels.route_dense``) for CUDA tensors;
``kalman_filter_plain``, the same step as a Python loop of torch ops, is
its plain version, which the wrapper takes only for CPU tensors.
``rts_smoother`` is the backward half of kernel K4 (``csrc/info_scan.cu``;
K4-wide for 16 < k <= 32, K4-gen for 32 < k <= 128); ``rts_smoother_plain``
is its plain-torch version, which the wrapper takes only for CPU tensors.

Missing data keeps static shapes: for mask w_t the masked model is
    Lam_t = diag(w_t) Lam,  y_t -> w_t * y_t,  R_t = w_t * R + (1 - w_t)
so masked rows have zero loading, zero innovation and unit variance.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..ops.linalg import chol_logdet, chol_solve, psd_cholesky, sym
from .params import FilterResult, SmootherResult, SSMParams

__all__ = ["kalman_filter", "kalman_filter_plain", "rts_smoother",
           "rts_smoother_plain"]

_LOG2PI = 1.8378770664093453  # log(2*pi)


def _masked_obs(y_t, mask_t, Lam, R):
    """Apply the static-shape masking rewrite; no-op when mask_t is None."""
    if mask_t is None:
        return y_t, Lam, R
    w = mask_t.to(y_t.dtype)
    return w * torch.nan_to_num(y_t), w[:, None] * Lam, w * R + (1.0 - w)


def kalman_filter_plain(Y: torch.Tensor, p: SSMParams,
                        mask: Optional[torch.Tensor] = None) -> FilterResult:
    """Plain twin of ``kalman_filter``: the step as a Python loop of torch
    ops.  Joseph-form covariance update."""
    dtype = Y.dtype
    p = p.to(dtype=dtype)
    T, N = Y.shape
    k = p.Lam.shape[1]
    I_k = torch.eye(k, dtype=dtype, device=Y.device)
    x, P = p.mu0, p.P0
    xp, Pp, xf, Pf, lls = [], [], [], [], []
    for t in range(T):
        m_t = None if mask is None else mask[t]
        y_m, H, r = _masked_obs(Y[t], m_t, p.Lam, p.R)
        v = y_m - H @ x
        S = H @ P @ H.T + torch.diag(r)
        L = psd_cholesky(S)
        Sinv_v = chol_solve(L, v)
        K = chol_solve(L, H @ P).T         # (k, N)
        x_f = x + K @ v
        IKH = I_k - K @ H
        P_f = sym(IKH @ P @ IKH.T + (K * r) @ K.T)
        n_t = (m_t.to(dtype).sum() if m_t is not None
               else torch.tensor(float(N), dtype=dtype, device=Y.device))
        lls.append(-0.5 * (n_t * _LOG2PI + chol_logdet(L) + v @ Sinv_v))
        xp.append(x)
        Pp.append(P)
        xf.append(x_f)
        Pf.append(P_f)
        x = p.A @ x_f
        P = sym(p.A @ P_f @ p.A.T + p.Q)
    return FilterResult(torch.stack(xp), torch.stack(Pp), torch.stack(xf),
                        torch.stack(Pf), torch.stack(lls).sum())


def kalman_filter(Y: torch.Tensor, p: SSMParams,
                  mask: Optional[torch.Tensor] = None) -> FilterResult:
    """Forward filter with exact log-likelihood; O(T N^3).

    Y: (T, N); mask: optional (T, N) {0,1}.  Joseph-form covariance update.
    Kernel K15 for CUDA tensors (N <= 32, k <= 32; K15-gen to N = 128 and k
    = 128, with a workspace; past that ``NotImplementedError`` before any
    launch), the plain version for CPU tensors.
    """
    if Y.device.type == "cpu":
        return kalman_filter_plain(Y, p, mask)
    T, N = Y.shape
    k = p.Lam.shape[1]
    dt, dev = Y.dtype, Y.device
    kernel = kernels.route_dense("dense_filter", N, k)
    p = SSMParams(*(x.to(dt).contiguous() for x in p))
    Y = Y.contiguous()
    ins = [("Y", Y, (T, N)), ("Lam", p.Lam, (N, k)), ("R", p.R, (N,)),
           ("A", p.A, (k, k)), ("Q", p.Q, (k, k)), ("mu0", p.mu0, (k,)),
           ("P0", p.P0, (k, k))]
    if mask is not None:
        mask = mask.to(dt).contiguous()
        ins.append(("mask", mask, (T, N)))
    for name, x, shape in ins:
        kernels.check_tensor(name, x, shape, dt, dev)
    x_pred = torch.empty((T, k), dtype=dt, device=dev)
    P_pred = torch.empty((T, k, k), dtype=dt, device=dev)
    x_filt = torch.empty((T, k), dtype=dt, device=dev)
    P_filt = torch.empty((T, k, k), dtype=dt, device=dev)
    lls = torch.empty((T,), dtype=dt, device=dev)
    work = () if kernel == "dense_filter" else (torch.empty(
        (kernels.query("dense_gen_work", dt, N, k),), dtype=dt, device=dev),)
    kernels.launch(kernel, dt, Y, mask, p.Lam, p.R, p.A, p.Q, p.mu0,
                   p.P0, x_pred, P_pred, x_filt, P_filt, lls, *work, T, N, k)
    return FilterResult(x_pred, P_pred, x_filt, P_filt, lls.sum())


def rts_smoother_plain(kf: FilterResult, p: SSMParams) -> SmootherResult:
    """Backward RTS pass; lag-one covariances P_lag[t] = P_sm[t] J_{t-1}'."""
    dtype = kf.x_filt.dtype
    A = p.A.to(dtype)
    T, k = kf.x_filt.shape
    # J_t = P_filt[t] A' P_pred[t+1]^{-1} for t = 0..T-2, batched up front.
    APf = A @ kf.P_filt[:-1]                                 # A P_filt[t]
    J = chol_solve(psd_cholesky(kf.P_pred[1:]), APf).transpose(-1, -2)
    x_sm = torch.empty_like(kf.x_filt)
    P_sm = torch.empty_like(kf.P_filt)
    x_sm[-1], P_sm[-1] = kf.x_filt[-1], kf.P_filt[-1]
    x_next, P_next = kf.x_filt[-1], kf.P_filt[-1]
    for t in range(T - 2, -1, -1):
        J_t = J[t]
        x_next = kf.x_filt[t] + J_t @ (x_next - kf.x_pred[t + 1])
        P_next = sym(kf.P_filt[t]
                     + J_t @ (P_next - kf.P_pred[t + 1]) @ J_t.T)
        x_sm[t], P_sm[t] = x_next, P_next
    P_lag = torch.zeros_like(P_sm)
    P_lag[1:] = P_sm[1:] @ J.transpose(-1, -2)               # P_sm[t] J_{t-1}'
    return SmootherResult(x_sm, P_sm, P_lag)


def rts_smoother(kf: FilterResult, p: SSMParams) -> SmootherResult:
    """RTS smoother: kernel K4-backward for CUDA tensors (K4-wide for
    16 < k <= 32, K4-gen for 32 < k <= 128, with a (4, k, k) workspace),
    the plain version for CPU tensors."""
    x_filt = kf.x_filt
    if x_filt.device.type == "cpu":
        return rts_smoother_plain(kf, p)
    T, k = x_filt.shape
    dt, dev = x_filt.dtype, x_filt.device
    kernel = kernels.route("rts_smoother", k)
    A = p.A.to(dt).contiguous()
    for name, x, shape in (("x_pred", kf.x_pred, (T, k)),
                           ("P_pred", kf.P_pred, (T, k, k)),
                           ("x_filt", kf.x_filt, (T, k)),
                           ("P_filt", kf.P_filt, (T, k, k)),
                           ("A", A, (k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    x_sm = torch.empty((T, k), dtype=dt, device=dev)
    P_sm = torch.empty((T, k, k), dtype=dt, device=dev)
    P_lag = torch.empty((T, k, k), dtype=dt, device=dev)
    work = (torch.empty((4, k, k), dtype=dt, device=dev),) \
        if kernel == kernels.GEN["rts_smoother"] else ()
    kernels.launch(kernel, dt, kf.x_pred, kf.P_pred, kf.x_filt,
                   kf.P_filt, A, x_sm, P_sm, P_lag, *work, T, k)
    return SmootherResult(x_sm, P_sm, P_lag)
