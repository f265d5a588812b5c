"""Rank-r computation-aware Kalman filter and smoother: the wide-k engine.

The PyTorch twin of ``dfm_tpu.ssm.lowrank_filter`` (arXiv 2405.08971).
Each step conditions on r <= k linear functionals of the observation
instead of the full information update, and keeps the posterior
covariance as the exact prediction minus a rank-r DOWNDATE:

    policy     V = top-r eigenvectors of C = Lam' R^{-1} Lam     (k, r)
    project    J_t = C_t V,  Gam_t = V'C_t V + eps I             (r, r)
    update     S_t = J_t' P J_t + Gam_t,   u_t = b_t - C_t x
               x_f = x + P J_t S_t^{-1} V'u_t
               P_f = P - (P J_t) S_t^{-1} (P J_t)'
    loglik     log|S_t| - log|Gam_t| and z'(Gam^{-1} - S^{-1})z, z = V'u,
               in place of the exact log|I + L'C_t L| and u'P_f u

The downdate is conservative (P_f here >= the exact P_f), the loglik is
the exact log-density of the rank-r approximating Gaussian, and at r = k
the engine reproduces the exact filter.  The smoother restricts the
backward gain to the same subspace: G1_t = P_f,t A'V and
Sigma_t = V'P_pred,t+1 V + eps I, with only r x r solves.  The whole
algorithm is invariant to V -> V B, so only the projector V V' matters.

Three routines are kernels on CUDA tensors (``csrc/lowrank_scan.cu``
for k <= 100 and r <= 32; past either, to k = 128 and any r <= k, the
generic kernels of ``csrc/gen_filters.cu``, which keep their matrices in
a global workspace the wrapper allocates: ``kernels.route_lowrank``),
each with its plain twin beside it; a wrapper takes the twin only for CPU
tensors.  Each takes a leading lane axis: a lone call is one lane, a
fleet bucket passes its B lanes in one launch.

- K9-basis ``lowrank_basis``: the top-r eigenvectors of C (a Jacobi
  eigensolve in shared memory; the twin is ``torch.linalg.eigh``, whose
  CUDA form reads the host).  ``policy_basis`` forms C with
  ``torch.matmul`` and calls it.
- K9-fwd ``lowrank_scan``: the T-step downdate filter scan.
- K9-bwd ``lowrank_smoother_scan``: the projected RTS pass with its
  lag-one covariances.

The kernels take 1 <= r <= k <= 128 (past 128 a CUDA call raises naming
the ROADMAP row before any launch); the twins any k.  The one E-step
computes V once and hands it to both scans (``lowrank_filter_smoother``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..ops.linalg import (chol_logdet, chol_small, chol_solve_small,
                          default_jitter, sym)
from ..ops.precision import accum_dtype
from .info_filter import _LOG2PI, ObsStats, obs_stats, quad_local
from .params import FilterResult, SmootherResult, SSMParams

__all__ = ["DEFAULT_MAX_RANK", "resolve_rank", "policy_basis",
           "lowrank_basis", "lowrank_basis_plain", "lowrank_scan",
           "lowrank_scan_plain", "lowrank_smoother_scan",
           "lowrank_smoother_scan_plain", "lowrank_from_stats",
           "lowrank_loglik_from_terms", "lowrank_filter", "lowrank_smoother",
           "lowrank_filter_smoother", "state_coverage"]

# Auto-rank cap (the JAX package's; ``cpu_ref.resolve_rank`` agrees).
DEFAULT_MAX_RANK = 8


def resolve_rank(k: int, rank: int = 0) -> int:
    """rank <= 0 -> auto (min(k, DEFAULT_MAX_RANK)); else clamp to [1, k]."""
    if rank <= 0:
        return min(k, DEFAULT_MAX_RANK)
    return max(1, min(int(rank), int(k)))


def _eye(r: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(r, dtype=like.dtype, device=like.device)


def lowrank_basis_plain(C: torch.Tensor, r: int) -> torch.Tensor:
    """Plain twin of K9-basis: the top-r eigenvectors (largest first) of
    sym(C), over any leading axes, (..., k, k) -> (..., k, r)."""
    _, vecs = torch.linalg.eigh(sym(C))
    return vecs.flip(-1)[..., :r].contiguous()


def _gen_work(which: int, B: int, k: int, r: int, like) -> tuple:
    """The generic kernel's (B, n) workspace (``lowrank_gen_work`` in
    ``csrc/gen_filters.cu`` gives n: 0 basis, 1 forward, 2 backward)."""
    n = kernels.query("lowrank_gen_work", like.dtype, which, k, r)
    return (torch.empty((B, n), dtype=like.dtype, device=like.device),)


def lowrank_basis(C: torch.Tensor, r: int) -> torch.Tensor:
    """K9-basis on B lanes, (B, k, k) -> (B, k, r): the kernel for CUDA
    tensors (K9-basis-gen past k = 100 or r = 32)."""
    if C.device.type == "cpu":
        return lowrank_basis_plain(C, r)
    B, k = C.shape[0], C.shape[-1]
    kernel = kernels.route_lowrank("lowrank_basis", k, r)
    kernels.check_tensor("C", C, (B, k, k), C.dtype, C.device)
    V = torch.empty((B, k, r), dtype=C.dtype, device=C.device)
    work = () if kernel == "lowrank_basis" else _gen_work(0, B, k, r, C)
    kernels.launch(kernel, C.dtype, C, V, *work, B, k, r)
    return V


def policy_basis(Lam: torch.Tensor, R: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r eigenvectors of the static observation information
    C = Lam' R^{-1} Lam: Lam (N, k), R (N,) -> (k, r), or a bucket's
    stacked (B, N, k), (B, N) -> (B, k, r).  One k x k eigensolve per
    E-step, not per time step."""
    lone = Lam.ndim == 2
    Lb, Rb = (Lam[None], R[None]) if lone else (Lam, R)
    C = torch.matmul((Lb * (1.0 / Rb)[..., None]).transpose(-1, -2), Lb)
    V = lowrank_basis(C.contiguous(), r)
    return V[0] if lone else V


def lowrank_scan_plain(b, C, V, A, Q, mu0, P0):
    """Plain twin of K9-fwd on B lanes: b (B, T, k), C (B, T, k, k) or a
    static (B, k, k), V (B, k, r), A, Q, P0 (B, k, k), mu0 (B, k).
    Returns (x_pred, P_pred, x_filt, P_filt, logdetG, corr), lane-major,
    with logdetG_t = log|S_t| - log|Gam_t| and corr_t =
    z'(Gam^{-1} - S^{-1})z (the JAX scan, batched)."""
    B, T, k = b.shape
    r = V.shape[-1]
    eps = default_jitter(b.dtype)
    I_r = _eye(r, b)
    Vt = V.transpose(-1, -2)
    static = C.ndim == 3
    if static:
        # Time-invariant precision: one projection for every step.
        J = C @ V
        Gam = sym(Vt @ J) + eps * I_r
        Lg = chol_small(Gam)
        ldg = chol_logdet(Lg)
        Ginv = chol_solve_small(Lg, I_r.expand(B, r, r))
    else:
        J = torch.einsum("btkl,blr->btkr", C, V)
        Gam = sym(torch.einsum("blr,btls->btrs", V, J)) + eps * I_r
        Lg = chol_small(Gam)
        ldg = chol_logdet(Lg)
        Ginv = chol_solve_small(Lg, I_r.expand(B, T, r, r))
    x, P = mu0, P0
    out = [[], [], [], [], [], []]
    for t in range(T):
        C_t, J_t, Gam_t, Ginv_t, ldg_t = (
            (C, J, Gam, Ginv, ldg) if static
            else (C[:, t], J[:, t], Gam[:, t], Ginv[:, t], ldg[:, t]))
        u = b[:, t] - (C_t @ x[..., None])[..., 0]
        z = (Vt @ u[..., None])[..., 0]
        PJ = P @ J_t
        S = sym(J_t.transpose(-1, -2) @ PJ) + Gam_t
        Ls = chol_small(S)
        a = chol_solve_small(Ls, z)
        x_f = x + (PJ @ a[..., None])[..., 0]
        P_f = sym(P - PJ @ chol_solve_small(Ls, PJ.transpose(-1, -2)))
        ld = chol_logdet(Ls) - ldg_t
        corr = ((z * (Ginv_t @ z[..., None])[..., 0]).sum(-1)
                - (z * a).sum(-1))
        for lst, v in zip(out, (x, P, x_f, P_f, ld, corr)):
            lst.append(v)
        x = (A @ x_f[..., None])[..., 0]
        P = sym(A @ P_f @ A.transpose(-1, -2) + Q)
    return tuple(torch.stack(v, dim=1) for v in out)


def lowrank_scan(b, C, V, A, Q, mu0, P0):
    """K9-fwd on B lanes (shapes of ``lowrank_scan_plain``): the kernel
    for CUDA tensors (K9-fwd-gen past k = 100 or r = 32), one launch for
    every lane."""
    if b.device.type == "cpu":
        return lowrank_scan_plain(b, C, V, A, Q, mu0, P0)
    B, T, k = b.shape
    r = V.shape[-1]
    dt, dev = b.dtype, b.device
    kernel = kernels.route_lowrank("lowrank_scan", k, r)
    static = C.ndim == 3
    for name, x, shape in (("b", b, (B, T, k)),
                           ("C", C, (B, k, k) if static else (B, T, k, k)),
                           ("V", V, (B, k, r)), ("A", A, (B, k, k)),
                           ("Q", Q, (B, k, k)), ("mu0", mu0, (B, k)),
                           ("P0", P0, (B, k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    x_pred = torch.empty((B, T, k), dtype=dt, device=dev)
    P_pred = torch.empty((B, T, k, k), dtype=dt, device=dev)
    x_filt = torch.empty((B, T, k), dtype=dt, device=dev)
    P_filt = torch.empty((B, T, k, k), dtype=dt, device=dev)
    logdetG = torch.empty((B, T), dtype=dt, device=dev)
    corr = torch.empty((B, T), dtype=dt, device=dev)
    work = () if kernel == "lowrank_scan" else _gen_work(1, B, k, r, b)
    kernels.launch(kernel, dt, b, C, k * k if static else T * k * k,
                   0 if static else k * k, V, A, Q, mu0, P0, x_pred, P_pred,
                   x_filt, P_filt, logdetG, corr, *work, B, T, k, r)
    return x_pred, P_pred, x_filt, P_filt, logdetG, corr


def lowrank_smoother_scan_plain(x_pred, P_pred, x_filt, P_filt, A, V):
    """Plain twin of K9-bwd on B lanes: (x_sm, P_sm, P_lag), lane-major,
    P_lag[:, 0] = 0 (the JAX smoother, batched)."""
    B, T, k = x_filt.shape
    r = V.shape[-1]
    eps = default_jitter(x_filt.dtype)
    I_r = _eye(r, x_filt)
    Vt = V.transpose(-1, -2)
    AV = A.transpose(-1, -2) @ V
    Sig = sym(torch.einsum("blr,btlm,bms->btrs", V, P_pred[:, 1:], V)) \
        + eps * I_r
    Lsig = chol_small(Sig)
    G1 = torch.einsum("btkl,blr->btkr", P_filt[:, :-1], AV)
    x_sm = torch.empty_like(x_filt)
    P_sm = torch.empty_like(P_filt)
    x_sm[:, -1], P_sm[:, -1] = x_filt[:, -1], P_filt[:, -1]
    xn, Pn = x_filt[:, -1], P_filt[:, -1]
    for t in range(T - 2, -1, -1):
        L_t, G_t = Lsig[:, t], G1[:, t]
        a = chol_solve_small(L_t, (Vt @ (xn - x_pred[:, t + 1])[..., None])
                             [..., 0])
        xn = x_filt[:, t] + (G_t @ a[..., None])[..., 0]
        E = Vt @ Pn @ V - Sig[:, t] + eps * I_r
        S = chol_solve_small(
            L_t, chol_solve_small(L_t, E).transpose(-1, -2)).transpose(-1, -2)
        Pn = sym(P_filt[:, t] + G_t @ sym(S) @ G_t.transpose(-1, -2))
        x_sm[:, t], P_sm[:, t] = xn, Pn
    # Lag-one covariances P_sm,t V Sigma_{t-1}^{-1} (V'A P_f,t-1).
    Minv = chol_solve_small(Lsig, I_r.expand(B, T - 1, r, r))
    PV = torch.einsum("btkl,blr->btkr", P_sm[:, 1:], V)
    P_lag = torch.zeros_like(P_sm)
    P_lag[:, 1:] = torch.einsum("btkr,btrs,btls->btkl", PV, Minv, G1)
    return x_sm, P_sm, P_lag


def lowrank_smoother_scan(x_pred, P_pred, x_filt, P_filt, A, V):
    """K9-bwd on B lanes: the kernel for CUDA tensors (K9-bwd-gen past k =
    100 or r = 32), one launch for every lane."""
    if x_filt.device.type == "cpu":
        return lowrank_smoother_scan_plain(x_pred, P_pred, x_filt, P_filt,
                                           A, V)
    B, T, k = x_filt.shape
    r = V.shape[-1]
    dt, dev = x_filt.dtype, x_filt.device
    kernel = kernels.route_lowrank("lowrank_smoother", k, r)
    for name, x, shape in (("x_pred", x_pred, (B, T, k)),
                           ("P_pred", P_pred, (B, T, k, k)),
                           ("x_filt", x_filt, (B, T, k)),
                           ("P_filt", P_filt, (B, T, k, k)),
                           ("A", A, (B, k, k)), ("V", V, (B, k, r))):
        kernels.check_tensor(name, x, shape, dt, dev)
    # Scratch: A'V for K9-bwd's own kernel, the generic kernel's workspace.
    work = ((torch.empty((B, k, r), dtype=dt, device=dev),)
            if kernel == "lowrank_smoother" else _gen_work(2, B, k, r, x_filt))
    x_sm = torch.empty((B, T, k), dtype=dt, device=dev)
    P_sm = torch.empty((B, T, k, k), dtype=dt, device=dev)
    P_lag = torch.empty((B, T, k, k), dtype=dt, device=dev)
    kernels.launch(kernel, dt, x_pred, P_pred, x_filt, P_filt, A, V, *work,
                   x_sm, P_sm, P_lag, B, T, k, r)
    return x_sm, P_sm, P_lag


def _basis_for(p: SSMParams, rank: int, V, dtype) -> torch.Tensor:
    if V is None:
        V = policy_basis(p.Lam, p.R, resolve_rank(p.A.shape[-1], rank))
    return V.to(dtype)


def lowrank_from_stats(stats: ObsStats, p: SSMParams, rank: int = 0,
                       V: Optional[torch.Tensor] = None):
    """Rank-r scan given precomputed observation statistics: (x_pred,
    P_pred, x_filt, P_filt, logdetG (T,), corr (T,)), the loglik terms of
    ``lowrank_loglik_from_terms``.  ``V`` (k, r): the policy basis, made
    here when None."""
    V = _basis_for(p, rank, V, stats.b.dtype)
    out = lowrank_scan(stats.b[None], stats.C[None], V[None], p.A[None],
                       p.Q[None], p.mu0[None], p.P0[None])
    return tuple(x[0] for x in out)


def lowrank_loglik_from_terms(stats: ObsStats, logdetG, corr, quad_R):
    """sum_t ll_t from the scan's (logdetG, corr) and the residual pass's
    quad_R, assembled in the accumulation dtype (the ``loglik_from_terms``
    twin with u'P_f u replaced by the subspace correction)."""
    acc = accum_dtype()
    quad = quad_R.to(acc) - corr.to(acc)
    lls = -0.5 * (stats.n.to(acc) * _LOG2PI + stats.ldR.to(acc)
                  + logdetG.to(acc) + quad)
    return lls.sum(-1)


def lowrank_filter(Y: torch.Tensor, p: SSMParams,
                   mask: Optional[torch.Tensor] = None, rank: int = 0,
                   V: Optional[torch.Tensor] = None) -> FilterResult:
    """Rank-r filter with the contract of ``info_filter``: observation
    stats (K2 when masked), K9-fwd, the residual pass K1, the loglik."""
    p = p.to(dtype=Y.dtype)
    stats = obs_stats(Y, p.Lam, p.R, mask=mask)
    xp, Pp, xf, Pf, logdetG, corr = lowrank_from_stats(stats, p, rank, V)
    quad_R = quad_local(Y, p.Lam, p.R, xp, mask)
    ll = lowrank_loglik_from_terms(stats, logdetG, corr, quad_R)
    return FilterResult(xp, Pp, xf, Pf, ll)


def lowrank_smoother(kf: FilterResult, p: SSMParams, rank: int = 0,
                     V: Optional[torch.Tensor] = None) -> SmootherResult:
    """Rank-r RTS smoother with the contract of ``rts_smoother`` (P_lag
    row 0 is zeros): K9-bwd."""
    dtype = kf.x_filt.dtype
    p = p.to(dtype=dtype)
    V = _basis_for(p, rank, V, dtype)
    out = lowrank_smoother_scan(kf.x_pred[None], kf.P_pred[None],
                                kf.x_filt[None], kf.P_filt[None], p.A[None],
                                V[None])
    return SmootherResult(*(x[0] for x in out))


def lowrank_filter_smoother(Y, p, mask=None, rank: int = 0):
    """Filter and smoother at one policy basis (one K9-basis launch)."""
    p = p.to(dtype=Y.dtype)
    V = _basis_for(p, rank, None, Y.dtype)
    kf = lowrank_filter(Y, p, mask=mask, rank=rank, V=V)
    return kf, lowrank_smoother(kf, p, rank=rank, V=V)


def state_coverage(x, P, truth, z: float = 1.6448536269514722) -> float:
    """Empirical z-interval coverage of a state trajectory: the fraction
    of (t, i) cells with |truth - x| <= z sqrt(diag P) (90% two-sided at
    the default z).  The conservative downdate can only widen it."""
    x = np.asarray(x, dtype=np.float64)
    truth = np.asarray(truth, dtype=np.float64)
    sd = np.sqrt(np.maximum(
        np.diagonal(np.asarray(P, dtype=np.float64), axis1=-2, axis2=-1),
        0.0))
    return float(np.mean(np.abs(truth - x) <= z * sd))
