"""Batched multi-fit EM engine: B independent problems in one program.

The PyTorch twin of the fit half of ``dfm_tpu.estim.batched``.  EM
restarts, k-grid refits (``estim.select``) and rolling-window evaluation
(``estim.evaluate``) are B independent fits of same-shaped (T, N) panels;
``fit_many`` stacks them along a leading batch axis and runs every EM
iteration of all B as one pass per stage:

    obs stats (torch.matmul)  ->  K4b-fwd  ->  K1b + f64 loglik
    ->  K4b-bwd  ->  closed-form M-step (torch.matmul; K6b row solves)

with per-problem convergence tracked in a device carry (running /
converged / diverged / padded).  A finished problem freezes through
``torch.where`` selects, with the stop rules of a lone fit, the
divergence roll-back to the params entering the pre-drop iteration
included.  The host reads once a chunk of ``fused_chunk`` iterations
(state, trace lengths, logliks and metrics in one packed buffer) and once
at the end (params and the smoothed moments), so a ``fit_many`` reads
n_chunks + 1 times.

Four routines are kernels on CUDA tensors, each with its plain-torch twin
beside it (the wrapper takes the twin only for CPU tensors): K4b-fwd
``_batched_info_scan`` and K4b-bwd ``_batched_rts`` (``csrc/info_scan.cu``,
K4 with one block per lane), K1b ``_batched_quad`` (``csrc/quad_local.cu``)
and K6b ``_bsolve_rows`` (``csrc/bsolve_rows.cu``).  Each wrapper, the
fleet's below too, takes its kernel through ``kernels.route``: the k <= 16
kernel, at 16 < k <= 32 its wide twin and at 32 < k <= 128 its generic
twin (``kernels.GEN``), each in the same source; past 128 it raises
``NotImplementedError``.  Unlike the JAX twins' time-major scans,
the scan kernels take and return batch-major (B, T, ...) tensors;
``_batched_filter``, ``_batched_rts`` and ``batched_m_step`` keep the JAX
layout.

Problems may differ by init (restarts), by data (windows) or by active
factor count (k-grid): a k_b < k_max problem is padded with inert trailing
factors (zero loading columns, a zero row and column of A, identity blocks
of Q and P0, zero mu0), which EM keeps exactly inert, so the padded
problem's trace is the unpadded problem's.  ``Hetero`` adds the
mixed-shape bundle (trailing pad steps, inert pad series, per-lane stop
knobs and tuned hypers) that ``run_batched_em(hetero=...)`` takes.

Not ported here, each raising ``NotImplementedError`` where the JAX
package takes it: ``backend="sharded"`` and ``n_devices`` (ROADMAP Queue
1 item 12), ``pipeline`` (item 4).  There is no ``robust`` keyword until
item 5 ports the guard; without faults the unguarded path computes what
the JAX package's guarded default computes.  ``pad_panel_to_t`` also
serves the capacity-padded panels of ``serve.session``.

The serving twins below the M-step are the fleet's (``serve.batched``,
``fleet``): the elementwise-masked filter and M-step over B capacity
buffers, whose kernels are K2b-m ``_batched_obs_stats_masked``
(``csrc/obs_stats.cu``), K4b-fwd with a per-step C
(``_batched_info_scan`` given C (B, T, k, k): the JAX package's
``_batched_info_scan_tv``), K1b-m ``_batched_quad_masked``
(``csrc/quad_local.cu``) and K3b-m ``_batched_mstep_rows``
(``csrc/mstep_rows.cu``), each with its plain twin beside it, and the
plain ragged append (``batched_ragged_append``; the fleet's kernel K13b
fuses it with the ring eviction, ``serve.batched``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..api import DynamicFactorModel, TorchBackend
from ..backends import cpu_ref
from ..ops.linalg import (UNROLL_K_MAX, chol_logdet, chol_solve,
                          chol_solve_unrolled, chol_unrolled, default_jitter,
                          psd_cholesky, sym)
from ..ops.precision import accum_dtype, highest_precision
from ..robust.health import health_from_trace
from ..ssm.params import SSMParams
from ..utils import refuse_unported
from ..utils.data import standardize, validate_panel
from .em import EMConfig, noise_floor_for
from .fused import read_packed

__all__ = ["DFMBatchSpec", "BatchFitResult", "fit_many", "run_batched_em",
           "stack_params", "unstack_params", "pad_params_to_k",
           "slice_params_to_k", "batched_m_step", "Hetero", "make_hetero",
           "pad_panel_to_t", "pad_panel_to_n", "pad_params_to_n",
           "slice_params_to_n", "batched_ragged_append",
           "batched_filter_masked", "batched_m_step_masked"]

_LOG2PI = 1.8378770664093453


# ---------------------------------------------------------------------------
# Small-matrix batched linalg
# ---------------------------------------------------------------------------

def _bT(M):
    return M.transpose(-1, -2)


def bchol(P, jitter=None):
    """Batched PSD Cholesky: the unrolled form for k <= UNROLL_K_MAX,
    ``psd_cholesky`` above it, as the JAX package branches; both
    symmetrize, add the dtype's jitter and give NaN on a negative pivot."""
    if jitter is None:
        jitter = default_jitter(P.dtype)
    if P.shape[-1] <= UNROLL_K_MAX:
        return chol_unrolled(sym(P), jitter)
    return psd_cholesky(P, jitter)


def bchol_solve(L, B):
    if L.shape[-1] <= UNROLL_K_MAX:
        return chol_solve_unrolled(L, B)
    return chol_solve(L, B)


def _bsolve_rows_plain(S, V):
    """Plain twin of K6b: V (B, n, k) rows, S (B, k, k) -> X with
    X[b, i, :] = S_b^{-1} V[b, i, :]."""
    if S.shape[-1] <= UNROLL_K_MAX:
        return chol_solve_unrolled(bchol(S)[..., None, :, :], V)
    return _bT(chol_solve(psd_cholesky(S), _bT(V)))


def _bsolve_rows(S, V):
    """The row-wise PSD solve of the batched M-step: kernel K6b for CUDA
    tensors (K6b-wide for 16 < k <= 32, K6b-gen for 32 < k <= 128, with a
    (B, k, k) workspace for the lanes' factors)."""
    if S.device.type == "cpu":
        return _bsolve_rows_plain(S, V)
    B, n, k = V.shape
    dt, dev = V.dtype, V.device
    kernel = kernels.route("batched_solve_rows", k)
    S, V = S.contiguous(), V.contiguous()
    kernels.check_tensor("S", S, (B, k, k), dt, dev)
    kernels.check_tensor("V", V, (B, n, k), dt, dev)
    X = torch.empty_like(V)
    work = (torch.empty((B, k, k), dtype=dt, device=dev),) \
        if kernel == kernels.GEN["batched_solve_rows"] else ()
    kernels.launch(kernel, dt, S, V, X, *work, B, n, k)
    return X


# ---------------------------------------------------------------------------
# Param stacking / k-grid padding (NumPy)
# ---------------------------------------------------------------------------

def stack_params(ps: Sequence, dtype=torch.float64,
                 device="cpu") -> SSMParams:
    """Stack per-problem NumPy params (same shapes) into one tensor
    ``SSMParams`` with a leading B axis on every leaf."""
    fields = zip(*((p.Lam, p.A, p.Q, p.R, p.mu0, p.P0) for p in ps))
    return SSMParams(*(torch.tensor(np.stack([np.asarray(x) for x in xs]),
                                    dtype=dtype, device=device)
                       for xs in fields))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def unstack_params(p) -> List[cpu_ref.SSMParams]:
    """Split batched params (tensor or NumPy leaves) into per-problem
    NumPy f64 params."""
    leaves = [_host(x) for x in p]
    B = leaves[0].shape[0]
    return [cpu_ref.SSMParams(*(lf[b] for lf in leaves)) for b in range(B)]


def pad_params_to_k(p, k_max: int) -> cpu_ref.SSMParams:
    """Pad a k-factor param set to k_max with INERT trailing factors: zero
    loading columns, a zero block of A, identity blocks of Q and P0, zero
    mu0.  EM keeps them inert; ``slice_params_to_k`` drops them."""
    k = p.Lam.shape[1]
    if k > k_max:
        raise ValueError(f"params have k={k} > k_max={k_max}")
    if k == k_max:
        return p
    m = k_max - k
    N = p.Lam.shape[0]

    def block(M, fill_eye):
        out = (np.eye(k_max, dtype=np.float64) if fill_eye
               else np.zeros((k_max, k_max)))
        out[:k, :k] = M
        return out

    return cpu_ref.SSMParams(
        Lam=np.concatenate([np.asarray(p.Lam, np.float64),
                            np.zeros((N, m))], axis=1),
        A=block(p.A, fill_eye=False),
        Q=block(p.Q, fill_eye=True),
        R=np.asarray(p.R, np.float64),
        mu0=np.concatenate([np.asarray(p.mu0, np.float64), np.zeros(m)]),
        P0=block(p.P0, fill_eye=True))


def slice_params_to_k(p, k: int) -> cpu_ref.SSMParams:
    """Drop the inert trailing factors: leading-k slice of every block."""
    return cpu_ref.SSMParams(Lam=p.Lam[:, :k], A=p.A[:k, :k], Q=p.Q[:k, :k],
                             R=p.R, mu0=p.mu0[:k], P0=p.P0[:k, :k])


# Mixed shapes: a pad SERIES is a zero-observation, zero-loading,
# unit-variance row (out of every k-dim reduction, log 1 = 0 in ldR; the
# M-step keeps its loading row zero and re-pins its R to 1); a pad STEP is
# a trailing masked time index, where the filter holds its carry, so the
# smoothed real prefix is the unpadded run's, and the loglik pieces and
# moment sums are where-masked with per-lane denominators.

def pad_panel_to_n(Y: np.ndarray, n_max: int) -> np.ndarray:
    """Pad a (T, N) panel to (T, n_max) with exact-zero inert series
    columns (pair with ``pad_params_to_n``)."""
    T, N = Y.shape
    if N > n_max:
        raise ValueError(f"panel has N={N} > n_max={n_max}")
    if N == n_max:
        return Y
    return np.concatenate([Y, np.zeros((T, n_max - N), Y.dtype)], axis=1)


def pad_panel_to_t(Y: np.ndarray, t_max: int) -> np.ndarray:
    """Pad a (T, N) panel to (t_max, N) with exact-zero trailing time
    steps (masked out of a fit by ``Hetero.t_mask``, out of a session by
    its zero mask)."""
    T, N = Y.shape
    if T > t_max:
        raise ValueError(f"panel has T={T} > t_max={t_max}")
    if T == t_max:
        return Y
    return np.concatenate([Y, np.zeros((t_max - T, N), Y.dtype)], axis=0)


def pad_params_to_n(p, n_max: int) -> cpu_ref.SSMParams:
    """Pad an N-series param set to n_max with INERT trailing series: zero
    loading rows and unit idiosyncratic variance.  ``slice_params_to_n``
    drops them."""
    N = p.Lam.shape[0]
    if N > n_max:
        raise ValueError(f"params have N={N} > n_max={n_max}")
    if N == n_max:
        return p
    m = n_max - N
    k = p.Lam.shape[1]
    return cpu_ref.SSMParams(
        Lam=np.concatenate([np.asarray(p.Lam, np.float64),
                            np.zeros((m, k))], axis=0),
        A=np.asarray(p.A, np.float64), Q=np.asarray(p.Q, np.float64),
        R=np.concatenate([np.asarray(p.R, np.float64), np.ones(m)]),
        mu0=np.asarray(p.mu0, np.float64), P0=np.asarray(p.P0, np.float64))


def slice_params_to_n(p, n: int) -> cpu_ref.SSMParams:
    """Drop the inert trailing series: leading-n slice of Lam rows and R."""
    return cpu_ref.SSMParams(Lam=p.Lam[:n], A=p.A, Q=p.Q, R=p.R[:n],
                             mu0=p.mu0, P0=p.P0)


class Hetero(NamedTuple):
    """Per-problem heterogeneity bundle of a mixed-shape batched fit; every
    leaf leads with the batch axis.

    t_mask:      (B, T) compute dtype; 1.0 on real steps, 0.0 on the pad
                 tail (trailing only; step 0 is real).
    n_mask:      (B, N) compute dtype; 1.0 on real series, 0.0 on pads.
    n_act:       (B,) f64; true series count (loglik constant).
    t_act:       (B,) compute dtype; true step count (M-step denominators).
    tol:         (B,) f64; per-problem relative tolerance.
    noise_floor: (B,) f64; per-problem divergence floor, from the
                 problem's own n_obs = T_act * N_act.
    iter_cap:    (B,) int32; per-problem max EM iterations.
    q_scale:     optional (B,) compute dtype; tuned hyper Q <- q_scale Q.
    r_scale:     optional (B,); R <- max(r_scale R, r_floor).
    lam_ridge:   optional (B,); ridge on the loading normal equations.
                 With any of the three set, a lane's loglik drop is its
                 plateau stop, not a divergence (generalized EM).
    """

    t_mask: torch.Tensor
    n_mask: torch.Tensor
    n_act: torch.Tensor
    t_act: torch.Tensor
    tol: torch.Tensor
    noise_floor: torch.Tensor
    iter_cap: torch.Tensor
    q_scale: Optional[torch.Tensor] = None
    r_scale: Optional[torch.Tensor] = None
    lam_ridge: Optional[torch.Tensor] = None


def make_hetero(t_act, n_act, T: int, N: int, *, dtype, tol, iter_cap,
                noise_floor_mult: float = 100.0, q_scale=None, r_scale=None,
                lam_ridge=None, device="cpu") -> Hetero:
    """A ``Hetero`` bundle for problems of true sizes (t_act, n_act) padded
    into a (T, N) bucket, on ``device``.  ``tol`` / ``iter_cap`` and the
    optional hypers broadcast from scalars or per-problem sequences; the
    noise floors come from ``noise_floor_for(dtype, t * n)``, as a lone fit
    of each problem would compute them."""
    t_act = np.asarray(t_act, np.int64).reshape(-1)
    n_act = np.asarray(n_act, np.int64).reshape(-1)
    B = len(t_act)
    if len(n_act) != B:
        raise ValueError("t_act and n_act lengths differ")
    if (t_act < 1).any() or (t_act > T).any():
        raise ValueError(f"t_act entries must lie in [1, {T}]")
    if (n_act < 1).any() or (n_act > N).any():
        raise ValueError(f"n_act entries must lie in [1, {N}]")
    acc = accum_dtype()
    nf = [noise_floor_for(dtype, int(t * n), mult=noise_floor_mult)
          for t, n in zip(t_act, n_act)]

    def lanes(v, dt):
        return torch.tensor(np.broadcast_to(np.asarray(v), (B,)).copy(),
                            dtype=dt, device=device)

    def hyper(v):
        return None if v is None else lanes(np.asarray(v, np.float64), dtype)

    return Hetero(
        t_mask=torch.tensor(np.arange(T)[None, :] < t_act[:, None],
                            dtype=dtype, device=device),
        n_mask=torch.tensor(np.arange(N)[None, :] < n_act[:, None],
                            dtype=dtype, device=device),
        n_act=lanes(n_act, acc),
        t_act=lanes(t_act, dtype),
        tol=lanes(np.asarray(tol, np.float64), acc),
        noise_floor=lanes(np.asarray(nf), acc),
        iter_cap=lanes(np.asarray(iter_cap, np.int64), torch.int32),
        q_scale=hyper(q_scale), r_scale=hyper(r_scale),
        lam_ridge=hyper(lam_ridge))


# ---------------------------------------------------------------------------
# Batched information-form filter + RTS smoother
# ---------------------------------------------------------------------------

def _batched_obs_stats(Y, Lam, R):
    """Per-problem k-dim observation reductions (unmasked): b (B, T, k),
    C (B, k, k), ldR (B,) f64.  Two batched products (the only place N
    appears)."""
    G = Lam / R[..., None]                          # (B, N, k)
    b = torch.matmul(Y, G)
    C = torch.matmul(_bT(Lam), G)
    ldR = torch.log(R).to(accum_dtype()).sum(-1)
    return b, C, ldR


def _batched_info_scan_plain(b, C, A, Q, mu0, P0, t_mask=None):
    """Plain twin of K4b-fwd: the k x k info-form scan over B problems,
    batch-major b (B, T, k) in, batch-major (x_pred, P_pred, x_filt,
    P_filt, logdetG) out.  C is (B, k, k), static per lane, or (B, T, k,
    k), one per step (the fleet's scan, the JAX ``_batched_info_scan_tv``,
    where a dead capacity step, C_t = 0, is an exact no-op update whose
    prediction still advances).  ``t_mask``
    (B, T) holds a problem's carry at its pad steps (selected, never
    multiplied)."""
    T, k = b.shape[1], b.shape[2]
    I_k = torch.eye(k, dtype=b.dtype, device=b.device)
    x, P = mu0, P0
    out = [[], [], [], [], []]
    for t in range(T):
        C_t = C if C.ndim == 3 else C[:, t]
        Lp = bchol(P)
        G = I_k + _bT(Lp) @ (C_t @ Lp)              # >= I: no jitter needed
        Lg = bchol(G, jitter=0.0)
        P_f = sym(Lp @ bchol_solve(Lg, _bT(Lp)))
        u = b[:, t] - (C_t @ x[..., None])[..., 0]
        x_f = x + (P_f @ u[..., None])[..., 0]
        if t_mask is not None:
            s = t_mask[:, t] > 0
            x_f = torch.where(s[:, None], x_f, x)
            P_f = torch.where(s[:, None, None], P_f, P)
        for lst, v in zip(out, (x, P, x_f, P_f, chol_logdet(Lg))):
            lst.append(v)
        x_n = (A @ x_f[..., None])[..., 0]
        P_n = sym(A @ P_f @ _bT(A) + Q)
        if t_mask is not None:
            x_n = torch.where(s[:, None], x_n, x)
            P_n = torch.where(s[:, None, None], P_n, P)
        x, P = x_n, P_n
    return tuple(torch.stack(v, dim=1) for v in out)


def _batched_info_scan(b, C, A, Q, mu0, P0, t_mask=None):
    """The batched k x k scan (batch-major): kernel K4b-fwd for CUDA
    tensors (K4b-wide for 16 < k <= 32, K4b-gen for 32 < k <= 128, with a
    (B, 4, k, k) workspace)."""
    if b.device.type == "cpu":
        return _batched_info_scan_plain(b, C, A, Q, mu0, P0, t_mask)
    B, T, k = b.shape
    dt, dev = b.dtype, b.device
    kernel = kernels.route("batched_info_scan", k)
    tv = C.ndim == 4
    ins = [x.contiguous() for x in (b, C, A, Q, mu0, P0)]
    for name, x, shape in zip(("b", "C", "A", "Q", "mu0", "P0"), ins,
                              ((B, T, k), (B, T, k, k) if tv else (B, k, k),
                               (B, k, k), (B, k, k), (B, k), (B, k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    if t_mask is not None:
        t_mask = t_mask.contiguous()
        kernels.check_tensor("t_mask", t_mask, (B, T), dt, dev)
    x_pred = torch.empty((B, T, k), dtype=dt, device=dev)
    P_pred = torch.empty((B, T, k, k), dtype=dt, device=dev)
    x_filt = torch.empty_like(x_pred)
    P_filt = torch.empty_like(P_pred)
    logdetG = torch.empty((B, T), dtype=dt, device=dev)
    b, C, A, Q, mu0, P0 = ins
    c_lane, c_stride = (T * k * k, k * k) if tv else (k * k, 0)
    work = (torch.empty((B, 4, k, k), dtype=dt, device=dev),) \
        if kernel == kernels.GEN["batched_info_scan"] else ()
    kernels.launch(kernel, dt, b, C, c_lane, c_stride, A, Q, mu0, P0, t_mask,
                   x_pred, P_pred, x_filt, P_filt, logdetG, *work, B, T, k)
    return x_pred, P_pred, x_filt, P_filt, logdetG


def _mask_t(a, t_mask):
    """Zero a batch-major (B, T, ...) tensor at pad steps by a select (not
    a multiply: pad-step junk must not reach the sums even as 0 * inf)."""
    m = t_mask.reshape(t_mask.shape + (1,) * (a.ndim - 2)) > 0
    return torch.where(m, a, torch.zeros((), dtype=a.dtype, device=a.device))


def _batched_quad_plain(Y, Lam, R, x_pred, b, C):
    """Plain twin of K1b: (quad_R (B, T) f64, U (B, T, k)) with quad_R the
    residual quadratic sum_n (y - lam_n . x_pred)^2 / R_n and
    U = b - C x_pred (C symmetric)."""
    V = Y - torch.matmul(x_pred, _bT(Lam))
    quad = (V * (V / R[:, None, :])).to(accum_dtype()).sum(-1)
    return quad, b - torch.matmul(x_pred, _bT(C))


def _batched_quad(Y, Lam, R, x_pred, b, C):
    """The residual pass of the batched loglik: kernel K1b for CUDA
    tensors (K1b-wide for 16 < k <= 32, K1b-gen for 32 < k <= 128; the
    (B, T, N) residual is never stored)."""
    if Y.device.type == "cpu":
        return _batched_quad_plain(Y, Lam, R, x_pred, b, C)
    B, T, N = Y.shape
    k = Lam.shape[-1]
    dt, dev = Y.dtype, Y.device
    kernel = kernels.route("batched_quad", k)
    ins = [x.contiguous() for x in (Y, Lam, R, x_pred, b, C)]
    for name, x, shape in zip(("Y", "Lam", "R", "x_pred", "b", "C"), ins,
                              ((B, T, N), (B, N, k), (B, N), (B, T, k),
                               (B, T, k), (B, k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    quad = torch.empty((B, T), dtype=torch.float64, device=dev)
    U = torch.empty((B, T, k), dtype=dt, device=dev)
    kernels.launch(kernel, dt, *ins, quad, U, B, T, N, k)
    return quad, U


def _batched_loglik(Y, p, b, C, ldR, x_pred, P_filt, logdetG, hetero=None):
    """Per-problem loglik (B,) f64, the cancellation-free assembly of the
    lone info filter: residual-pass quad_R (K1b), U from the stats, U'P_f U
    in the compute dtype, (T,)-sized pieces assembled in f64.  With
    ``hetero`` the constant uses each problem's true series count and the
    per-step terms are where-masked to its real prefix."""
    acc = accum_dtype()
    quad_R, U = _batched_quad(Y, p.Lam, p.R, x_pred, b, C)
    upu = torch.einsum("btk,btkl,btl->bt", U, P_filt, U)
    n_const = (float(Y.shape[-1]) if hetero is None
               else hetero.n_act[:, None])
    lls = -0.5 * (n_const * _LOG2PI + ldR[:, None] + logdetG.to(acc)
                  + quad_R - upu.to(acc))
    if hetero is not None:
        lls = _mask_t(lls, hetero.t_mask)
    return lls.sum(1)


def _batched_scan(Y, p, hetero=None):
    """Stats + K4b-fwd: ((b, C, ldR), batch-major (x_pred, P_pred, x_filt,
    P_filt, logdetG))."""
    stats = _batched_obs_stats(Y, p.Lam, p.R)
    t_mask = None if hetero is None else hetero.t_mask
    return stats, _batched_info_scan(stats[0], stats[1], p.A, p.Q, p.mu0,
                                     p.P0, t_mask)


def _batched_filter(Y, p, hetero=None):
    """Info-form filter over the batch: (loglik (B,), batch-major (x_pred,
    P_pred, x_filt, P_filt) with shapes (B, T, ...))."""
    (b, C, ldR), (xp, Pp, xf, Pf, ldG) = _batched_scan(Y, p, hetero)
    ll = _batched_loglik(Y, p, b, C, ldR, xp, Pf, ldG, hetero=hetero)
    return ll, (xp, Pp, xf, Pf)


def _batched_rts_plain(xp, Pp, xf, Pf, A):
    """Plain twin of K4b-bwd: the batched RTS smoother (batch-major in and
    out): (x_sm (B, T, k), P_sm (B, T, k, k), P_lag (B, T, k, k))."""
    B, T, k = xf.shape
    APf = A[:, None] @ Pf[:, :-1]
    J = _bT(bchol_solve(bchol(Pp[:, 1:]), APf))     # (B, T-1, k, k)
    x_sm = torch.empty_like(xf)
    P_sm = torch.empty_like(Pf)
    x_sm[:, -1], P_sm[:, -1] = xf[:, -1], Pf[:, -1]
    x_next, P_next = xf[:, -1], Pf[:, -1]
    for t in range(T - 2, -1, -1):
        J_t = J[:, t]
        x_next = xf[:, t] + (J_t @ (x_next - xp[:, t + 1])[..., None])[..., 0]
        P_next = sym(Pf[:, t] + J_t @ (P_next - Pp[:, t + 1]) @ _bT(J_t))
        x_sm[:, t], P_sm[:, t] = x_next, P_next
    P_lag = torch.zeros_like(P_sm)
    P_lag[:, 1:] = P_sm[:, 1:] @ _bT(J)
    return x_sm, P_sm, P_lag


def _batched_rts(xp, Pp, xf, Pf, A):
    """Batched RTS smoother: kernel K4b-bwd for CUDA tensors (K4b-wide
    for 16 < k <= 32, K4b-gen for 32 < k <= 128, with a (B, 4, k, k)
    workspace)."""
    if xf.device.type == "cpu":
        return _batched_rts_plain(xp, Pp, xf, Pf, A)
    B, T, k = xf.shape
    dt, dev = xf.dtype, xf.device
    kernel = kernels.route("batched_rts", k)
    ins = [x.contiguous() for x in (xp, Pp, xf, Pf, A)]
    for name, x, shape in zip(("x_pred", "P_pred", "x_filt", "P_filt", "A"),
                              ins, ((B, T, k), (B, T, k, k), (B, T, k),
                                    (B, T, k, k), (B, k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    x_sm = torch.empty((B, T, k), dtype=dt, device=dev)
    P_sm = torch.empty((B, T, k, k), dtype=dt, device=dev)
    P_lag = torch.empty_like(P_sm)
    work = (torch.empty((B, 4, k, k), dtype=dt, device=dev),) \
        if kernel == kernels.GEN["batched_rts"] else ()
    kernels.launch(kernel, dt, *ins, x_sm, P_sm, P_lag, *work, B, T, k)
    return x_sm, P_sm, P_lag


# ---------------------------------------------------------------------------
# Batched M-step (closed forms, per problem)
# ---------------------------------------------------------------------------

def _outer(x):
    return x[..., :, None] * x[..., None, :]


def batched_m_step(Y, x_sm, P_sm, P_lag, p: SSMParams, cfg: EMConfig, Ysq,
                   hetero=None) -> SSMParams:
    """Per-problem closed-form M-step from batched smoother moments (all
    batch-major).  The moment sums are batched products; the Lam and A
    solves are K6b.  With ``hetero`` the sums run over the where-masked real
    prefix (each problem's last real step picked by the one-hot
    t_mask[t] - t_mask[t+1]), the denominators use t_act, pad series keep
    zero loading rows and R = 1, and the optional hypers apply."""
    if hetero is None:
        T = Y.shape[1]
        x_m, P_m, Pl_m = x_sm, P_sm, P_lag
        last = P_sm[:, -1] + _outer(x_sm[:, -1])
        T_r, T_q = float(T), float(T - 1)
    else:
        tm = hetero.t_mask
        x_m = _mask_t(x_sm, tm)
        P_m = _mask_t(P_sm, tm)
        Pl_m = _mask_t(P_lag, tm)
        lw = tm - torch.cat([tm[:, 1:], torch.zeros_like(tm[:, :1])], dim=1)
        x_last = torch.einsum("bt,bti->bi", lw, x_m)
        last = torch.einsum("bt,btij->bij", lw, P_m) + _outer(x_last)
        T_r = hetero.t_act[:, None]
        T_q = (hetero.t_act - 1.0)[:, None, None]
    S_ff = P_m.sum(1) + _bT(x_m) @ x_m
    first = P_sm[:, 0] + _outer(x_sm[:, 0])
    S_lag, S_cur = S_ff - last, S_ff - first
    S_cross = Pl_m[:, 1:].sum(1) + _bT(x_m[:, 1:]) @ x_m[:, :-1]
    S_yf = _bT(Y) @ x_m                              # (B, N, k)
    ridge = None if hetero is None else hetero.lam_ridge
    if ridge is not None:
        # With a ridge the OLS shortcut for R is biased: the full residual
        # quadratic, as the lone M-step computes it.
        eye_k = torch.eye(S_ff.shape[-1], dtype=S_ff.dtype,
                          device=S_ff.device)
        Lam = _bsolve_rows(S_ff + ridge[:, None, None] * eye_k, S_yf)
        quad = (Ysq - 2.0 * (Lam * S_yf).sum(-1)
                + torch.einsum("bnk,bkl,bnl->bn", Lam, S_ff, Lam))
        R = torch.clamp(quad / T_r, min=cfg.r_floor)
    else:
        Lam = _bsolve_rows(S_ff, S_yf)
        R = torch.clamp((Ysq - (Lam * S_yf).sum(-1)) / T_r, min=cfg.r_floor)
    if hetero is not None and hetero.r_scale is not None:
        R = torch.clamp(hetero.r_scale[:, None] * R, min=cfg.r_floor)
    if hetero is not None:
        nm = hetero.n_mask > 0
        Lam = torch.where(nm[..., None], Lam, torch.zeros((), dtype=Lam.dtype,
                                                          device=Lam.device))
        R = torch.where(nm, R, torch.ones((), dtype=R.dtype, device=R.device))
    A, Q = p.A, p.Q
    if cfg.estimate_A:
        A = _bsolve_rows(S_lag, S_cross)
        if cfg.estimate_Q:
            Q = sym((S_cur - A @ _bT(S_cross)) / T_q)
    elif cfg.estimate_Q:
        Q = sym((S_cur - A @ _bT(S_cross) - S_cross @ _bT(A)
                 + A @ S_lag @ _bT(A)) / T_q)
    if hetero is not None and hetero.q_scale is not None:
        Q = hetero.q_scale[:, None, None] * Q
    mu0, P0 = p.mu0, p.P0
    if cfg.estimate_init:
        mu0, P0 = x_sm[:, 0], sym(P_sm[:, 0])
    return SSMParams(*(x.contiguous() for x in (Lam, A, Q, R, mu0, P0)))


# ---------------------------------------------------------------------------
# Serving twins: the fleet's elementwise-masked batched filter and M-step
# and the ragged append (the B-way batch of serve/session.py's capacity-
# padded query; every formula mirrors dfm_tpu.estim.batched op for op, so
# a fleet lane pins to the same tenant's lone session)
# ---------------------------------------------------------------------------

def batched_ragged_append(Ybuf, Wbuf, rows, rmask, t_cur) -> None:
    """The append half of K13b's plain twin, in place: lane b's
    ``rows[b]`` / ``rmask[b]`` (r_max, N) land at rows t_cur[b] + j of
    ``Ybuf[b]`` / ``Wbuf[b]``, the rows past capacity dropped (the JAX
    scatter's ``mode="drop"``).  The host pads each lane's rows past its
    true count with exact zeros, so those land zeros on the already-zero
    pad region.  ``t_cur`` (B,) integer tensor."""
    T_cap, r_max = Ybuf.shape[1], rows.shape[1]
    for b, t0 in enumerate(t_cur.tolist()):
        n_in = max(0, min(r_max, T_cap - t0))
        Ybuf[b, t0:t0 + n_in] = rows[b, :n_in]
        Wbuf[b, t0:t0 + n_in] = rmask[b, :n_in]


def _batched_obs_stats_masked_plain(Y, W, Lam, R):
    """Plain twin of K2b-m: per-lane time-varying statistics of an
    elementwise-masked panel, b (B, T, k), C (B, T, k, k), n (B, T) f64,
    ldR (B, T) f64.  W encodes every missing cell, the dead capacity tail
    and the inert N-pad series, so a fully masked step gives exact zeros."""
    acc = accum_dtype()
    B, T, N = Y.shape
    k = Lam.shape[-1]
    Yw = W * torch.nan_to_num(Y)
    Rinv = 1.0 / R
    logR = torch.log(R).to(acc)
    G = Lam * Rinv[..., None]                       # (B, N, k)
    b = torch.matmul(Yw, G)
    LL = G[..., :, None] * Lam[..., None, :]        # (B, N, k, k)
    C = torch.matmul(W, LL.reshape(B, N, k * k)).reshape(B, T, k, k)
    n = W.sum(-1).to(acc)
    ldR = torch.matmul(W.to(acc), logR[..., None])[..., 0]
    return b, C, n, ldR


def _batched_obs_stats_masked(Y, W, Lam, R):
    """The fleet's masked statistics: kernel K2b-m for CUDA tensors
    (K2b-m-wide for 16 < k <= 32, K2b-m-gen for 32 < k <= 128)."""
    if Y.device.type == "cpu":
        return _batched_obs_stats_masked_plain(Y, W, Lam, R)
    B, T, N = Y.shape
    k = Lam.shape[-1]
    dt, dev = Y.dtype, Y.device
    kernel = kernels.route("batched_obs_stats", k)
    for name, x, shape in (("Y", Y, (B, T, N)), ("W", W, (B, T, N)),
                           ("Lam", Lam, (B, N, k)), ("R", R, (B, N))):
        kernels.check_tensor(name, x, shape, dt, dev)
    b = torch.empty((B, T, k), dtype=dt, device=dev)
    C = torch.empty((B, T, k, k), dtype=dt, device=dev)
    n = torch.empty((B, T), dtype=accum_dtype(), device=dev)
    ldR = torch.empty((B, T), dtype=accum_dtype(), device=dev)
    kernels.launch(kernel, dt, Y, Lam, R, W, b, C, n, ldR, B, T, N, k)
    return b, C, n, ldR


def _batched_quad_masked_plain(Y, W, Lam, R, x_pred, b, C):
    """Plain twin of K1b-m: (quad_R (B, T) f64, U (B, T, k)) with
    quad_R = sum_n w (y - lam_n . x_pred)^2 / R_n (a masked residual
    zeroed before it is squared) and U = b - C_t x_pred."""
    V = W * torch.nan_to_num(Y - torch.matmul(x_pred, _bT(Lam)))
    quad = (V * (V / R[:, None, :])).to(accum_dtype()).sum(-1)
    return quad, b - torch.einsum("btkl,btl->btk", C, x_pred)


def _batched_quad_masked(Y, W, Lam, R, x_pred, b, C):
    """The residual pass of the fleet's loglik: kernel K1b-m for CUDA
    tensors (K1b-m-wide for 16 < k <= 32, K1b-m-gen for 32 < k <=
    128)."""
    if Y.device.type == "cpu":
        return _batched_quad_masked_plain(Y, W, Lam, R, x_pred, b, C)
    B, T, N = Y.shape
    k = Lam.shape[-1]
    dt, dev = Y.dtype, Y.device
    kernel = kernels.route("batched_quad_masked", k)
    ins = [x.contiguous() for x in (Y, Lam, R, x_pred, W, b, C)]
    for name, x, shape in zip(("Y", "Lam", "R", "x_pred", "W", "b", "C"), ins,
                              ((B, T, N), (B, N, k), (B, N), (B, T, k),
                               (B, T, N), (B, T, k), (B, T, k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    quad = torch.empty((B, T), dtype=torch.float64, device=dev)
    U = torch.empty((B, T, k), dtype=dt, device=dev)
    kernels.launch(kernel, dt, *ins, quad, U, B, T, N, k)
    return quad, U


def _batched_loglik_masked(Y, W, p, b, C, n, ldR, x_pred, P_filt, logdetG):
    """Per-lane loglik (B,) f64 of the masked fleet filter: the residual
    pass (K1b-m), U'P_f U in the compute dtype, assembly in f64.  Fully
    masked steps contribute exact zeros."""
    acc = accum_dtype()
    quad_R, U = _batched_quad_masked(Y, W, p.Lam, p.R, x_pred, b, C)
    upu = torch.einsum("btk,btkl,btl->bt", U, P_filt, U)
    lls = -0.5 * (n * _LOG2PI + ldR + logdetG.to(acc) + quad_R
                  - upu.to(acc))
    return lls.sum(1)


def batched_filter_masked(Y, W, p):
    """Elementwise-masked info-form filter over the lanes: (loglik (B,),
    batch-major (x_pred, P_pred, x_filt, P_filt)), the B-way twin of
    ``info_filter(Y, p, mask=W)`` over a capacity-padded panel."""
    b, C, n, ldR = _batched_obs_stats_masked(Y, W, p.Lam, p.R)
    xp, Pp, xf, Pf, ldG = _batched_info_scan(b, C, p.A, p.Q, p.mu0, p.P0)
    ll = _batched_loglik_masked(Y, W, p, b, C, n, ldR, xp, Pf, ldG)
    return ll, (xp, Pp, xf, Pf)


def _batched_mstep_rows_plain(Y, W, x_sm, EffT, P_sm, r_floor: float):
    """Plain twin of K3b-m: per lane and series, S_yf,i, S_ff,i (identity
    for a never-observed series, so its loading row is exactly zero), the
    k x k solve, and R_i = max((sum_t w resid^2 + the P_sm smear) /
    max(count, 1), r_floor).  Returns (Lam (B, N, k), R (B, N))."""
    B, T, N = Y.shape
    k = x_sm.shape[-1]
    Yz = torch.where(W > 0, torch.nan_to_num(Y), torch.zeros_like(Y))
    S_yf = torch.matmul(_bT(Yz), x_sm)                       # (B, N, k)
    S_ff = torch.matmul(_bT(W), EffT.reshape(B, T, k * k)).reshape(
        B, N, k, k)
    never = (W.sum(1) == 0)[..., None, None]
    eye = torch.eye(k, dtype=Y.dtype, device=Y.device)
    S_ff = torch.where(never, eye, S_ff)
    Lam = bchol_solve(bchol(S_ff), S_yf)
    counts = torch.clamp(W.sum(1), min=1.0)
    resid_sq = (W * (Yz - torch.matmul(x_sm, _bT(Lam))) ** 2).sum(1)
    PV = torch.matmul(_bT(W), P_sm.reshape(B, T, k * k)).reshape(B, N, k, k)
    smear = torch.einsum("bnk,bnkl,bnl->bn", Lam, PV, Lam)
    return Lam, torch.clamp((resid_sq + smear) / counts, min=r_floor)


def _batched_mstep_rows(Y, W, x_sm, EffT, P_sm, r_floor: float):
    """The fleet M-step's observation rows: kernel K3b-m for CUDA
    tensors (K3b-m-wide for 16 < k <= 32, K3b-m-gen for 32 < k <=
    128)."""
    if Y.device.type == "cpu":
        return _batched_mstep_rows_plain(Y, W, x_sm, EffT, P_sm, r_floor)
    B, T, N = Y.shape
    k = x_sm.shape[-1]
    dt, dev = Y.dtype, Y.device
    kernel = kernels.route("batched_mstep_rows", k)
    ins = [x.contiguous() for x in (Y, W, x_sm, EffT, P_sm)]
    for name, x, shape in zip(("Y", "W", "x_sm", "EffT", "P_sm"), ins,
                              ((B, T, N), (B, T, N), (B, T, k),
                               (B, T, k, k), (B, T, k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    Lam = torch.empty((B, N, k), dtype=dt, device=dev)
    R = torch.empty((B, N), dtype=dt, device=dev)
    kernels.launch(kernel, dt, *ins, Lam, R, B, T, N, k, float(r_floor))
    return Lam, R


def batched_m_step_masked(Y, W, x_sm, P_sm, P_lag, p: SSMParams,
                          cfg: EMConfig, t_new) -> SSMParams:
    """Closed-form masked M-step per lane, the batched twin of
    ``em._m_step(Y, mask, ..., n_steps=t_new)`` with per-lane live lengths
    ``t_new`` ((B,) integer tensor on the device): the observation rows
    are K3b-m, the dynamics take {0,1} time weights and the ``t_new - 1``
    transition divisor, A's row solve is K6b."""
    dt = Y.dtype
    T = Y.shape[1]
    EffT = P_sm + _outer(x_sm)                              # (B, T, k, k)
    cross = P_lag[:, 1:] + x_sm[:, 1:, :, None] * x_sm[:, :-1, None, :]
    Lam, R = _batched_mstep_rows(Y, W, x_sm, EffT, P_sm, cfg.r_floor)
    A, Q = p.A, p.Q
    if cfg.estimate_A or cfg.estimate_Q:
        t_idx = torch.arange(T, device=Y.device)[None, :]
        tn = t_new[:, None]
        w_lag = (t_idx < tn - 1).to(dt)
        w_cur = ((t_idx >= 1) & (t_idx < tn)).to(dt)
        w_x = (t_idx[:, :-1] < tn - 1).to(dt)
        S_lag = torch.einsum("bt,btkl->bkl", w_lag, EffT)
        S_cur = torch.einsum("bt,btkl->bkl", w_cur, EffT)
        S_cross = torch.einsum("bt,btkl->bkl", w_x, cross)
        T_q = (t_new.to(dt) - 1.0)[:, None, None]
        if cfg.estimate_A:
            A = _bsolve_rows(S_lag, S_cross)
            if cfg.estimate_Q:
                Q = sym((S_cur - A @ _bT(S_cross)) / T_q)
        elif cfg.estimate_Q:
            Q = sym((S_cur - A @ _bT(S_cross) - S_cross @ _bT(A)
                     + A @ S_lag @ _bT(A)) / T_q)
    mu0, P0 = p.mu0, p.P0
    if cfg.estimate_init:
        mu0, P0 = x_sm[:, 0], sym(P_sm[:, 0])
    return SSMParams(*(x.contiguous() for x in (Lam, A, Q, R, mu0, P0)))


# ---------------------------------------------------------------------------
# Fused chunk: n EM iterations with in-carry per-problem convergence
# ---------------------------------------------------------------------------

# Per-problem progress states carried through the chunks.
RUNNING, CONVERGED, DIVERGED, PADDED = 0, 1, 2, 3
STATE_NAMES = {RUNNING: "running", CONVERGED: "converged",
               DIVERGED: "diverged", PADDED: "padded"}


def _bmask(m, x):
    """Broadcast a (B,) bool against an arbitrary (B, ...) leaf."""
    return m.reshape(m.shape + (1,) * (x.ndim - 1))


def _em_chunk_core(Y, carry, tol, noise_floor, cfg: EMConfig, n_iters: int,
                   with_metrics: bool = False, hetero=None, Ysq=None):
    """n EM iterations over the batch with no host read.

    carry = (p, p_prev, ll_prev (B,) f64, state (B,) int32, n_lls (B,)
    int32): ``p`` embodies the updates so far, ``p_prev`` the params
    entering the previous active iteration (the divergence roll-back
    target), ``state`` the per-problem progress, ``n_lls`` the trace
    length.  Frozen problems still compute; their carry is held by
    ``torch.where`` selects, and the decision logic is the lone fit's
    ``em_progress`` (NaN -> continue).  ``tol`` / ``noise_floor`` are f64
    scalars or (B,) tensors; ``hetero`` overrides both and adds the
    per-problem ``iter_cap``.

    Returns (carry, lls (n_iters, B) f64, metrics): ``metrics`` is None, or
    with ``with_metrics`` the (n_iters, B, 3) f64 [loglik, delta, max
    param-update] record.
    """
    if hetero is not None:
        tol, noise_floor = hetero.tol, hetero.noise_floor
    if Ysq is None:
        Ysq = torch.einsum("btn,btn->bn", Y, Y)
    monotone = hetero is None or (hetero.q_scale is None
                                  and hetero.r_scale is None
                                  and hetero.lam_ridge is None)
    lls, mets = [], []
    for _ in range(n_iters):
        p, p_prev, ll_prev, state, n_lls = carry
        ll, (xp, Pp, xf, Pf) = _batched_filter(Y, p, hetero)
        x_sm, P_sm, P_lag = _batched_rts(xp, Pp, xf, Pf, p.A)
        p_new = batched_m_step(Y, x_sm, P_sm, P_lag, p, cfg, Ysq,
                               hetero=hetero)

        active = state == RUNNING
        if hetero is not None:
            active = active & (n_lls < hetero.iter_cap)
        n_new = n_lls + active.to(n_lls.dtype)
        rel = (ll - ll_prev) / torch.clamp(ll_prev.abs(), min=1e-12)
        drop = ll_prev - ll
        conv_rel = (tol > 0) & (rel.abs() < tol)
        # Hyper-scaled lanes are generalized EM: a drop is their plateau
        # stop, not a divergence.
        diverged = (drop > noise_floor) & monotone
        conv_plateau = (drop > 0) & (tol > 0)
        prog = torch.where(
            conv_rel, CONVERGED,
            torch.where(diverged, DIVERGED,
                        torch.where(conv_plateau, CONVERGED, RUNNING)))
        prog = torch.where(n_new < 2, RUNNING, prog).to(state.dtype)
        new_state = torch.where(active, prog, state)

        adv = active & (prog != DIVERGED)   # take this iteration's update
        roll = active & (prog == DIVERGED)  # roll back to pre-drop entry
        p_out = SSMParams(*(
            torch.where(_bmask(adv, new), new,
                        torch.where(_bmask(roll, cur), prv, cur))
            for new, prv, cur in zip(p_new, p_prev, p)))
        p_prev_out = SSMParams(*(
            torch.where(_bmask(active, cur), cur, prv)
            for cur, prv in zip(p, p_prev)))
        ll_prev_out = torch.where(active, ll, ll_prev)
        carry = (p_out, p_prev_out, ll_prev_out, new_state, n_new)
        lls.append(ll)
        if with_metrics:
            B = ll.shape[0]
            dparam = torch.stack([(new - cur).abs().reshape(B, -1).amax(1)
                                  for new, cur in zip(p_out, p)]).amax(0)
            mets.append(torch.stack([ll, ll - ll_prev,
                                     dparam.to(torch.float64)], dim=-1))
    lls_t = (torch.stack(lls) if lls else
             torch.zeros((0, Y.shape[0]), dtype=torch.float64,
                         device=Y.device))
    met_t = None
    if with_metrics:
        met_t = (torch.stack(mets) if mets else
                 torch.zeros((0, Y.shape[0], 3), dtype=torch.float64,
                             device=Y.device))
    return carry, lls_t, met_t


def _smooth_core(Y, p, hetero=None):
    """Batched filter + smoother -> (x_sm (B, T, k), P_sm (B, T, k, k)).
    The loglik, which the JAX twin computes and drops, is not formed."""
    _, (xp, Pp, xf, Pf, _) = _batched_scan(Y, p, hetero)
    x_sm, P_sm, _ = _batched_rts(xp, Pp, xf, Pf, p.A)
    return x_sm, P_sm


# ---------------------------------------------------------------------------
# Host chunk driver
# ---------------------------------------------------------------------------

def run_batched_em(Y, p0: SSMParams, cfg: EMConfig, max_iters: int,
                   tol: float, fused_chunk: int = 8,
                   with_metrics: bool = False, hetero=None, pipeline=None,
                   policy=None, scan_impl=None, state0=None,
                   scan_impl_metrics=None, scan_impl_capped=None,
                   scan_impl_capped_metrics=None):
    """Chunked host driver around the batched EM chunk.

    ``Y`` (B, T, N) and ``p0`` (batched ``SSMParams``) are tensors on one
    device in one dtype.  Runs ceil(max_iters / fused_chunk) chunks at
    most and stops as soon as every problem has left RUNNING (or, with
    ``hetero``, reached its own iteration cap).  Each chunk ends in ONE
    blocking read: state, trace lengths, logliks (and metrics) packed into
    one buffer; the carry stays on the device.

    Returns (params (batched SSMParams on the device), lls_list
    (per-problem trace arrays), converged (B,) bool, p_iters (B,) int,
    healths (B,) list); with ``with_metrics`` a 6th element, the
    (total_iters, B, 3) f64 [loglik, delta, max param-update] block.
    ``healths[b].n_chunks`` is the number of chunks, each one read.

    ``hetero``: mixed-shape mode; each problem's tol / noise floor / cap
    come from the bundle (the scalar ``tol`` is then ignored).
    ``pipeline`` (speculative chunk issue) is not ported: ROADMAP Queue 1
    item 4; nor the JAX keywords ``policy`` (the guarded dispatch, item 5)
    and ``scan_impl``, ``scan_impl_metrics``, ``scan_impl_capped``,
    ``scan_impl_capped_metrics``, ``state0`` (the sharded batched EM, item
    12): each raises ``NotImplementedError`` when given.
    """
    refuse_unported(
        "run_batched_em", ("policy", policy is not None, 5),
        ("scan_impl", scan_impl is not None, 12),
        ("state0", state0 is not None, 12),
        ("scan_impl_metrics", scan_impl_metrics is not None, 12),
        ("scan_impl_capped", scan_impl_capped is not None, 12),
        ("scan_impl_capped_metrics", scan_impl_capped_metrics is not None,
         12))
    if pipeline not in (None, 0):
        raise NotImplementedError(
            "run_batched_em(pipeline=) is not ported to dfm_tpu_torch yet: "
            "ROADMAP Queue 1 item 4")
    B, T, N = Y.shape
    dev = Y.device
    acc = accum_dtype()
    nf = noise_floor_for(Y.dtype, T * N, mult=cfg.noise_floor_mult)
    nf_b = (np.full((B,), float(nf)) if hetero is None
            else _host(hetero.noise_floor))
    cap_h = None if hetero is None else _host(hetero.iter_cap)
    fused_chunk = max(1, int(fused_chunk))
    tol_t = torch.tensor(float(tol), dtype=acc, device=dev)
    nf_t = torch.tensor(float(nf), dtype=acc, device=dev)
    carry = (p0, p0, torch.zeros((B,), dtype=acc, device=dev),
             torch.zeros((B,), dtype=torch.int32, device=dev),
             torch.zeros((B,), dtype=torch.int32, device=dev))
    traces, metric_chunks = [], []
    state_h = np.zeros((B,))
    n_lls_h = np.zeros((B,))
    n_chunks = it = 0
    with highest_precision():
        Ysq = torch.einsum("btn,btn->bn", Y, Y)     # iteration-invariant
        while it < max_iters:
            n = min(fused_chunk, max_iters - it)
            carry, lls, mets = _em_chunk_core(
                Y, carry, tol_t, nf_t, cfg, n, with_metrics=with_metrics,
                hetero=hetero, Ysq=Ysq)
            host = read_packed({"state": carry[3], "n_lls": carry[4],
                                "lls": lls, "mets": mets})   # the one read
            state_h, n_lls_h = host["state"], host["n_lls"]
            traces.append(host["lls"])
            if with_metrics:
                metric_chunks.append(host["mets"])
            n_chunks += 1
            it += n
            done = state_h != RUNNING
            if cap_h is not None:
                done = done | (n_lls_h >= cap_h)
            if done.all():
                break
    n_lls_h = n_lls_h.astype(np.int64)
    all_lls = (np.concatenate(traces, axis=0) if traces
               else np.zeros((0, B)))
    lls_list = [all_lls[:n_lls_h[b], b] for b in range(B)]
    converged = state_h == CONVERGED
    p_iters = np.where(state_h == DIVERGED, np.maximum(n_lls_h - 2, 0),
                       n_lls_h)
    healths = []
    for b in range(B):
        h = health_from_trace(lls_list[b], noise_floor=float(nf_b[b]),
                              engine="batched_em")
        h.n_chunks = n_chunks
        healths.append(h)
    if with_metrics:
        metrics_all = (np.concatenate(metric_chunks, axis=0) if metric_chunks
                       else np.zeros((0, B, 3)))
        return carry[0], lls_list, converged, p_iters, healths, metrics_all
    return carry[0], lls_list, converged, p_iters, healths


# ---------------------------------------------------------------------------
# Public API: DFMBatchSpec / fit_many / BatchFitResult
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DFMBatchSpec:
    """B same-shaped DFM problems to fit in one batched program.

    Y: (B, T, N) stacked panels (fully observed).
    model: shared ``DynamicFactorModel`` (its ``n_factors`` is k_max).
    inits: optional per-problem NumPy params in STANDARDIZED units (what
        ``FitResult.params`` holds), each with k_b factors, padded to k_max
        internally.  None -> per-problem PCA warm start.
    k_active: optional (B,) active factor counts (the k-grid workload);
        None means every problem uses all ``model.n_factors`` factors.
    origins: optional (B,) window origins of a rolling-window spec
        (carried to the result, not used by the fit).
    """

    Y: np.ndarray
    model: object
    inits: Optional[list] = None
    k_active: Optional[np.ndarray] = None
    origins: Optional[np.ndarray] = None

    @classmethod
    def restarts(cls, model, Y, n_restarts: int, seed: int = 0,
                 jitter: float = 0.1) -> "DFMBatchSpec":
        """One panel, B jittered inits: restart 0 is the exact PCA warm
        start, the others perturb it (multiplicative loading noise,
        log-normal R noise)."""
        Y = np.asarray(Y, np.float64)
        Yz = standardize(Y)[0] if model.standardize else Y
        p0 = cpu_ref.pca_init(Yz, model.n_factors,
                              static=(model.dynamics == "static"))
        rng = np.random.default_rng(seed)
        inits = [p0]
        for _ in range(n_restarts - 1):
            inits.append(cpu_ref.SSMParams(
                Lam=p0.Lam * (1.0 + jitter * rng.standard_normal(p0.Lam.shape)),
                A=p0.A.copy(), Q=p0.Q.copy(),
                R=p0.R * np.exp(jitter * rng.standard_normal(p0.R.shape)),
                mu0=p0.mu0.copy(), P0=p0.P0.copy()))
        return cls(Y=np.broadcast_to(Y, (n_restarts,) + Y.shape).copy(),
                   model=model, inits=inits)

    @classmethod
    def k_grid(cls, Y, ks: Sequence[int], dynamics: str = "ar1",
               standardize: bool = True) -> "DFMBatchSpec":
        """One panel fit at each k in ``ks``, padded to k_max = max(ks)."""
        ks = np.asarray(sorted(ks), np.int64)
        Y = np.asarray(Y, np.float64)
        model = DynamicFactorModel(n_factors=int(ks.max()), dynamics=dynamics,
                                   standardize=standardize)
        return cls(Y=np.broadcast_to(Y, (len(ks),) + Y.shape).copy(),
                   model=model, k_active=ks)

    @classmethod
    def rolling_windows(cls, model, Y, origins: Sequence[int],
                        train_len: int) -> "DFMBatchSpec":
        """Fixed-length training windows ending at each origin: window w
        trains on Y[t0 - train_len:t0]."""
        Y = np.asarray(Y, np.float64)
        origins = np.asarray(origins, np.int64)
        if (origins < train_len).any() or (origins > Y.shape[0]).any():
            raise ValueError("origins must lie in [train_len, T]")
        stacked = np.stack([Y[t0 - train_len:t0] for t0 in origins])
        return cls(Y=stacked, model=model, origins=origins)


@dataclasses.dataclass
class BatchFitResult:
    """Per-problem results of a batched fit (NumPy f64, unpadded)."""

    params: list                  # per-problem cpu_ref.SSMParams (std units)
    logliks: list                 # per-problem loglik trace arrays
    converged: np.ndarray         # (B,) bool
    n_iters: np.ndarray           # (B,) trace lengths
    p_iters: np.ndarray           # (B,) EM updates the params embody
    factors: list                 # per-problem (T, k_b) smoothed means
    factor_cov: list              # per-problem (T, k_b, k_b)
    standardizers: list           # per-problem Standardizer | None
    health: list                  # per-problem robust.FitHealth
    model: object
    spec: DFMBatchSpec
    backend: str
    # (total_iters, B, 3) f64 [loglik, delta, max param-update] per
    # iteration when fit_many(with_metrics=True); None otherwise.
    metrics: Optional[np.ndarray] = None
    host_reads: Optional[int] = None   # blocking device->host reads: one
    # a chunk + the final packed one (+ one for the device_init PCA)

    @property
    def logliks_final(self) -> np.ndarray:
        return np.array([t[-1] if len(t) else np.nan for t in self.logliks])

    def best(self) -> int:
        """Index of the problem with the highest final loglik (restarts)."""
        return int(np.nanargmax(self.logliks_final))


def _resolve_backend(backend) -> TorchBackend:
    if backend is None:
        return TorchBackend()
    if isinstance(backend, TorchBackend):
        return backend
    if backend == "sharded":
        raise NotImplementedError(
            "fit_many(backend='sharded') is not ported to dfm_tpu_torch "
            "yet: ROADMAP Queue 1 item 12")
    raise ValueError(f"fit_many: backend must be a TorchBackend or None, "
                     f"got {backend!r}")


def fit_many(spec: DFMBatchSpec, backend=None, max_iters: int = 50,
             tol: float = 1e-6, dtype=None, fused_chunk: int = 8,
             n_devices: Optional[int] = None, device_init: bool = False,
             with_metrics: bool = False, pipeline=None,
             robust: bool = False) -> BatchFitResult:
    """Fit B independent DFM problems in one batched program per chunk.

    The batched twin of ``api.fit`` for same-shaped, fully-observed
    problems: standardize each panel (the host path of ``fit``), PCA warm
    starts (or ``spec.inits``), the batched info-form EM with in-carry
    convergence, and a final batched smooth.  The host reads once a chunk
    and once at the end, plus once for the ``device_init`` PCA
    (``BatchFitResult.host_reads``).

    backend: a ``TorchBackend`` (None means ``TorchBackend()``, CUDA);
    ``dtype`` defaults to the backend's.  ``device_init`` runs the batched
    Gram-eigh PCA init on the backend's device (uniform-k specs only).
    ``with_metrics`` fills ``BatchFitResult.metrics``.  ``backend="sharded"``,
    ``n_devices`` and ``pipeline`` raise ``NotImplementedError`` (ROADMAP
    Queue 1 items 12 and 4), and so does ``robust=True`` (the guarded
    driver, item 5; the JAX default, while the port's batched fits are
    unguarded).
    """
    refuse_unported("fit_many", ("robust", bool(robust), 5))
    if n_devices is not None:
        raise NotImplementedError(
            "fit_many(n_devices=) is not ported to dfm_tpu_torch yet: "
            "ROADMAP Queue 1 item 12")
    if pipeline not in (None, 0):
        raise NotImplementedError(
            "fit_many(pipeline=) is not ported to dfm_tpu_torch yet: "
            "ROADMAP Queue 1 item 4")
    b = _resolve_backend(backend)
    Y = np.asarray(spec.Y, np.float64)
    if Y.ndim != 3:
        raise ValueError(f"spec.Y must be (B, T, N), got {Y.shape}")
    if not np.isfinite(Y).all():
        raise ValueError("batched fits require fully-observed panels "
                         "(no NaN/mask support); use fit per problem")
    B, T, N = Y.shape
    model = spec.model
    k_max = model.n_factors
    if k_max > min(T, N):
        raise ValueError(f"n_factors={k_max} exceeds min(T, N)={min(T, N)}")
    k_act = (np.full((B,), k_max, np.int64) if spec.k_active is None
             else np.asarray(spec.k_active, np.int64))
    if len(k_act) != B:
        raise ValueError("k_active length != B")
    if (k_act < 1).any() or (k_act > k_max).any():
        raise ValueError("k_active entries must lie in [1, n_factors]")
    static = model.dynamics == "static"
    dt = b.dtype if dtype is None else dtype

    # Host prep: the same standardize() call fit uses, per problem.
    Yz = np.empty_like(Y)
    stds: list = []
    for i in range(B):
        validate_panel(Y[i], check_variance=model.standardize)
        if model.standardize:
            Yz[i], s = standardize(Y[i])
            stds.append(s)
        else:
            Yz[i] = Y[i]
            stds.append(None)
    Yt = torch.tensor(Yz, dtype=dt, device=b.device)

    # Per-problem inits (host PCA unless given), padded to k_max.
    init_reads = 0
    if spec.inits is not None:
        if len(spec.inits) != B:
            raise ValueError("spec.inits length != B")
        inits = [pad_params_to_k(p, k_max) for p in spec.inits]
    elif device_init and (k_act == k_max).all():
        from .init import pca_init_batched
        inits = pca_init_batched(Yt, k_max, static=static)   # one read
        init_reads = 1
    else:
        # One SVD a distinct panel: the k-grid's lanes share one panel.
        svds: dict = {}
        inits = []
        for i in range(B):
            key = hashlib.sha256(Yz[i].tobytes()).digest()
            if key not in svds:
                svds[key] = cpu_ref.pca_svd(Yz[i])
            inits.append(pad_params_to_k(cpu_ref.pca_init(
                Yz[i], int(k_act[i]), static=static, Vt=svds[key]), k_max))

    cfg = EMConfig(estimate_A=model.estimate_A, estimate_Q=model.estimate_Q,
                   estimate_init=model.estimate_init, filter="info")
    p0 = stack_params(inits, dtype=dt, device=b.device)
    metrics = None
    with highest_precision():
        out = run_batched_em(Yt, p0, cfg, max_iters, tol,
                             fused_chunk=fused_chunk,
                             with_metrics=with_metrics)
        p, lls_list, conv, p_iters, healths = out[:5]
        if with_metrics:
            metrics = out[5]
        x_sm, P_sm = _smooth_core(Yt, p)
        host = read_packed({**p._asdict(), "x_sm": x_sm,
                            "P_sm": P_sm})          # the final read
    n_chunks = healths[0].n_chunks if healths else 0
    params = [slice_params_to_k(pb, int(k_act[i])) for i, pb in
              enumerate(unstack_params([host[f] for f in SSMParams._fields]))]
    x_h, P_h = host["x_sm"], host["P_sm"]
    return BatchFitResult(
        params=params, logliks=lls_list, converged=np.asarray(conv),
        n_iters=np.array([len(t) for t in lls_list]),
        p_iters=np.asarray(p_iters),
        factors=[x_h[i, :, :k_act[i]] for i in range(B)],
        factor_cov=[P_h[i, :, :k_act[i], :k_act[i]] for i in range(B)],
        standardizers=stds, health=healths, model=model, spec=spec,
        backend=b.name, metrics=metrics,
        host_reads=init_reads + n_chunks + 1)
