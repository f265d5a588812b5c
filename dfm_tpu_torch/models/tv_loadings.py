"""Time-varying-loadings DFM (config S4, BASELINE.json:10).

The PyTorch twin of ``dfm_tpu.models.tv_loadings``.  Model:

    y_it = lam_it' f_t + eps_it,   lam_it = lam_i,t-1 + xi_it  (Var xi = tau2_i I)
    f_t = A f_{t-1} + eta_t

Conditional on the factor path the N loading chains are independent k-dim
linear-Gaussian chains; conditional on the loading paths the factors follow
an information-form SSM with per-step C_t, b_t.  Estimation alternates the
two exact conditional smoothers (a dual-Kalman scheme):

  A-step  factors | loadings: K2-tv (``obs_stats_tv``) -> K4-forward over
          the per-step C_t -> K1-tv (``quad_local_tv``) -> the f64 loglik ->
          K4-backward
  B-step  loadings | factors: K11-fwd (``loading_filter``) -> K11-bwd
          (``loading_smoother``) (csrc/tv_loadings.cu and tv_smoother.cu:
          to k = 16 a thread a series; past it csrc/tv_loadings_gen.cu, a
          block a series)
  M-bits  A, Q from the factor moments; R from the residuals and the
          loading-uncertainty smear; tau2 from the smoothed increments.

The reported loglik is the factor-filter loglik conditional on the current
loading paths (the exact joint likelihood is intractable).  Every kernel
wrapper runs its plain-torch twin (``*_plain``) for CPU tensors and the
kernel for CUDA tensors; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..backends.cpu_ref import pca_init
from ..estim import fused as _fused
from ..estim.em import moments, noise_floor_for, run_chunked
from ..ops.linalg import (UNROLL_K_MAX, chol_solve, chol_solve_unrolled,
                          chol_unrolled, matvec_vpu, psd_cholesky,
                          solve_psd, sym)
from ..ops.precision import (accum_dtype, default_compute_dtype,
                             highest_precision)
from ..robust.health import health_from_trace
from ..ssm.info_filter import ObsStats, info_scan, loglik_from_terms
from ..ssm.kalman import rts_smoother
from ..ssm.params import FilterResult, SSMParams
from ..utils import refuse_unported
from ..utils.data import build_mask

__all__ = ["TVLSpec", "TVLParams", "tvl_fit", "tvl_forecast", "TVLResult",
           "obs_stats_tv", "obs_stats_tv_plain", "quad_local_tv",
           "quad_local_tv_plain", "factor_pass_tv", "loading_filter",
           "loading_filter_plain", "loading_smoother",
           "loading_smoother_plain", "loading_pass", "loading_pass_plain",
           "tvl_round_core", "tvl_round_scan", "tvl_loglik_eval"]


@dataclasses.dataclass(frozen=True)
class TVLSpec:
    n_factors: int
    n_rounds: int = 10
    tol: float = 1e-6
    estimate_tau2: bool = True
    r_floor: float = 1e-6
    tau2_floor: float = 1e-10


class TVLParams(NamedTuple):
    """Lam0 (N, k) initial loadings; tau2 (N,) loading-walk variances;
    A, Q (k, k); R (N,); mu0 (k,); P0 (k, k)."""

    Lam0: torch.Tensor
    tau2: torch.Tensor
    A: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    mu0: torch.Tensor
    P0: torch.Tensor

    def to(self, device=None, dtype=None) -> "TVLParams":
        """Each field as a contiguous tensor on ``device`` in ``dtype``
        (fields may be tensors or NumPy arrays)."""
        return TVLParams(*(torch.as_tensor(x).to(device=device, dtype=dtype)
                           .contiguous() for x in self))

    @classmethod
    def from_numpy(cls, p, dtype=torch.float64, device="cpu") -> "TVLParams":
        """From any object with the seven fields as arrays (the JAX
        package's ``TVLParams`` included)."""
        return cls(*(torch.tensor(np.asarray(getattr(p, f)), dtype=dtype,
                                  device=device).contiguous()
                     for f in cls._fields))

    def to_numpy(self) -> "TVLParams":
        """The same fields as NumPy float64 arrays."""
        return TVLParams(*(x.detach().to("cpu", torch.float64).numpy()
                           for x in self))


# ---------------------------------------------------------------------------
# A-step: factor filter/smoother with time-varying loadings (info form)
# ---------------------------------------------------------------------------

def _kernel(name, k, specs, dt, dev) -> str:
    """The kernel entry point ``name`` launches at k (``kernels.route``:
    today's kernel to KMAX, the wide one to WIDE_KMAX, the generic one to
    GEN_KMAX; past that a raise naming the ROADMAP row), after the tensor
    checks: nothing is allocated or launched before either."""
    kernel = kernels.route(name, k)
    for arg, x, shape in specs:
        kernels.check_tensor(arg, x, shape, dt, dev)
    return kernel


def _smoother_work(k: int, N: int, dt, dev):
    """(workspace or None, slots) of ``loading_smoother_gen``: its C rule
    (``kernels.query``) says whether a series' four k x k matrices fit a
    block's shared memory (slots 0) or take a global workspace of slots
    series, each (4, k, k | 1), for a persistent grid over the series."""
    slots = kernels.query("loading_smoother_gen_slots", dt, k, N,
                          kernels.gen_ctas(dev, N))
    if not slots:
        return None, 0
    return torch.empty((slots, 4, k, k | 1), dtype=dt, device=dev), slots


def obs_stats_tv_plain(Y, Lam_t, R, mask=None) -> ObsStats:
    """Plain-torch info-form statistics with per-step loadings Lam_t
    (T, N, k); n_t and ldR_t in the accumulation dtype."""
    T, N = Y.shape
    acc = accum_dtype()
    Rinv = 1.0 / R
    logR = torch.log(R).to(acc)
    if mask is None:
        b = torch.einsum("tn,tnk->tk", Y * Rinv, Lam_t)
        C = torch.einsum("tnk,tnl->tkl", Lam_t * Rinv[:, None], Lam_t)
        n = torch.full((T,), float(N), dtype=acc, device=Y.device)
        ldR = logR.sum().expand(T).clone()
    else:
        W = mask.to(Y.dtype)
        Yw = W * torch.nan_to_num(Y)
        b = torch.einsum("tn,tnk->tk", Yw * Rinv, Lam_t)
        C = torch.einsum("tnk,tnl->tkl", Lam_t * (W * Rinv)[..., None],
                         Lam_t)
        n = W.to(acc).sum(dim=1)
        ldR = W.to(acc) @ logR
    return ObsStats(b, C.contiguous(), n, ldR)


def obs_stats_tv(Y, Lam_t, R, mask=None) -> ObsStats:
    """Info-form observation statistics with per-step loadings: kernel
    K2-tv (``csrc/obs_stats.cu``) for CUDA tensors, masked or not (its wide
    kernel at 16 < k <= 32, its generic one at 32 < k <= 128)."""
    if Y.device.type == "cpu":
        return obs_stats_tv_plain(Y, Lam_t, R, mask)
    T, N = Y.shape
    k = Lam_t.shape[-1]
    dt, dev = Y.dtype, Y.device
    specs = [("Y", Y, (T, N)), ("Lam_t", Lam_t, (T, N, k)), ("R", R, (N,))]
    if mask is not None:
        specs.append(("mask", mask, (T, N)))
    kernel = _kernel("tvl_obs_stats", k, specs, dt, dev)
    acc = accum_dtype()
    b = torch.empty((T, k), dtype=dt, device=dev)
    C = torch.empty((T, k, k), dtype=dt, device=dev)
    n = torch.empty((T,), dtype=acc, device=dev)
    ldR = torch.empty((T,), dtype=acc, device=dev)
    kernels.launch(kernel, dt, Y, Lam_t, R, mask, b, C, n, ldR, T, N, k)
    return ObsStats(b, C, n, ldR)


def quad_local_tv_plain(Y, Lam_t, R, x_pred, mask=None):
    """Plain-torch residual pass: (quad_R (T,) f64, U (T, k)), v = y -
    lam_t,n . x_pred,t (masked: w nan_to_num(v)), quad_R = sum v^2 / R,
    U = sum (v / R) lam_t,n."""
    V = Y - torch.einsum("tnk,tk->tn", Lam_t, x_pred)
    if mask is not None:
        V = mask.to(Y.dtype) * torch.nan_to_num(V)
    VR = V / R[None, :]
    quad = (V * VR).to(accum_dtype()).sum(dim=1)
    return quad, torch.einsum("tn,tnk->tk", VR, Lam_t)


def quad_local_tv(Y, Lam_t, R, x_pred, mask=None):
    """The residual pass of the A-step: kernel K1-tv
    (``csrc/quad_local.cu``) for CUDA tensors (its wide kernel at 16 < k
    <= 32, its generic one at 32 < k <= 128)."""
    if Y.device.type == "cpu":
        return quad_local_tv_plain(Y, Lam_t, R, x_pred, mask)
    T, N = Y.shape
    k = Lam_t.shape[-1]
    dt, dev = Y.dtype, Y.device
    specs = [("Y", Y, (T, N)), ("Lam_t", Lam_t, (T, N, k)), ("R", R, (N,)),
             ("x_pred", x_pred, (T, k))]
    if mask is not None:
        specs.append(("mask", mask, (T, N)))
    kernel = _kernel("tvl_quad", k, specs, dt, dev)
    quad = torch.empty((T,), dtype=torch.float64, device=dev)
    U = torch.empty((T, k), dtype=dt, device=dev)
    kernels.launch(kernel, dt, Y, Lam_t, R, x_pred, mask, quad, U, T, N, k)
    return quad, U


def _tv_filter(Y, Lam_t, p: TVLParams, mask=None) -> FilterResult:
    """K2-tv -> K4-forward -> K1-tv -> the f64 loglik."""
    stats = obs_stats_tv(Y, Lam_t, p.R, mask)
    xp, Pp, xf, Pf, logdetG = info_scan(stats, p.A, p.Q, p.mu0, p.P0)
    quad_R, U = quad_local_tv(Y, Lam_t, p.R, xp, mask)
    return FilterResult(xp, Pp, xf, Pf,
                        loglik_from_terms(stats, logdetG, Pf, quad_R, U))


def _smooth(kf: FilterResult, Lam_t, p: TVLParams):
    """K4-backward; the smoother reads only A of the params."""
    return rts_smoother(kf, SSMParams(Lam=Lam_t[0], A=p.A, Q=p.Q, R=p.R,
                                      mu0=p.mu0, P0=p.P0))


def factor_pass_tv(Y, Lam_t, p: TVLParams, mask=None, reduce_tree=None):
    """Filter + RTS smoother over factors given the loading paths.

    Returns (FilterResult, SmootherResult); loglik is conditional on Lam_t.
    ``reduce_tree`` (the series-sharded reduction) raises when given:
    ROADMAP Queue 1 item 12.
    """
    refuse_unported("factor_pass_tv", ("reduce_tree", reduce_tree is not None,
                                       12))
    kf = _tv_filter(Y, Lam_t, p, mask)
    return kf, _smooth(kf, Lam_t, p)


# ---------------------------------------------------------------------------
# B-step: the loading filter and smoother given the factor path
# ---------------------------------------------------------------------------

def loading_filter_plain(Y, F, Lam0, tau2, R, mask=None):
    """Plain-torch forward scan of the N loading chains: (lam_f (T, N, k),
    P_f (T, N, k, k)), the filtered moments of every step (the predicted
    ones are lam_f[t-1] and P_f[t-1] + tau2 I)."""
    T, N = Y.shape
    k = F.shape[1]
    I_k = torch.eye(k, dtype=Y.dtype, device=Y.device)
    Yz = torch.nan_to_num(Y)
    if mask is not None:
        W = mask.to(Y.dtype)
        Yz = Yz * W
    lam = Lam0
    P = (1e-2 + tau2)[:, None, None] * I_k[None]
    lam_f = torch.empty((T, N, k), dtype=Y.dtype, device=Y.device)
    P_f = torch.empty((T, N, k, k), dtype=Y.dtype, device=Y.device)
    for t in range(T):
        f = F[t]
        P_pred = P + tau2[:, None, None] * I_k[None]
        Pf = matvec_vpu(P_pred, f[None])                   # (N, k)
        S = (Pf * f[None, :]).sum(-1) + R                  # (N,)
        Kg = Pf if mask is None else W[t][:, None] * Pf
        Kg = Kg / S[:, None]
        v = Yz[t] - (lam * f[None, :]).sum(-1)
        lam = lam + Kg * v[:, None]
        P = sym(P_pred - Kg[:, :, None] * Pf[:, None, :])
        lam_f[t] = lam
        P_f[t] = P
    return lam_f, P_f


def loading_filter(Y, F, Lam0, tau2, R, mask=None):
    """The forward loading scan: kernel K11-fwd (``csrc/tv_loadings.cu``)
    for CUDA tensors (``loading_filter_gen`` at 16 < k <= 128)."""
    if Y.device.type == "cpu":
        return loading_filter_plain(Y, F, Lam0, tau2, R, mask)
    T, N = Y.shape
    k = F.shape[1]
    dt, dev = Y.dtype, Y.device
    specs = [("Y", Y, (T, N)), ("F", F, (T, k)), ("Lam0", Lam0, (N, k)),
             ("tau2", tau2, (N,)), ("R", R, (N,))]
    if mask is not None:
        specs.append(("mask", mask, (T, N)))
    kernel = _kernel("loading_filter", k, specs, dt, dev)
    lam_f = torch.empty((T, N, k), dtype=dt, device=dev)
    P_f = torch.empty((T, N, k, k), dtype=dt, device=dev)
    kernels.launch(kernel, dt, Y, mask, F, Lam0, tau2, R, lam_f, P_f, T, N,
                   k)
    return lam_f, P_f


def loading_smoother_plain(lam_f, P_f, tau2):
    """Plain-torch reverse scan: (lam_sm (T, N, k), P_sm (T, N, k, k),
    incr (N,)), incr the summed E|lam_t+1 - lam_t|^2.  The J' solve takes
    the JAX package's branches: unrolled Cholesky for k <= UNROLL_K_MAX,
    the batched factorization above; the k x k products are batched
    matmuls (the JAX function's broadcast multiply-and-sum forms an (N, k,
    k, k) temporary a product)."""
    T, N, k = lam_f.shape
    I_k = torch.eye(k, dtype=lam_f.dtype, device=lam_f.device)
    small_k = k <= UNROLL_K_MAX
    lam_sm = torch.empty_like(lam_f)
    P_sm = torch.empty_like(P_f)
    lam_n, P_n = lam_f[-1], P_f[-1]
    lam_sm[-1], P_sm[-1] = lam_n, P_n
    incr = torch.zeros((N,), dtype=lam_f.dtype, device=lam_f.device)
    for t in range(T - 2, -1, -1):
        lf, Pfm = lam_f[t], P_f[t]
        P_p = Pfm + tau2[:, None, None] * I_k[None]         # P_pred[t+1]
        if small_k:
            JT = chol_solve_unrolled(chol_unrolled(P_p), Pfm)
        else:
            JT = chol_solve(psd_cholesky(P_p, jitter=0.0), Pfm)
        J = JT.transpose(-1, -2)
        lam_s = lf + matvec_vpu(J, lam_n - lf)
        P_s = sym(Pfm + (J @ (P_n - P_p)) @ JT)
        P_lag = P_n @ JT
        d = lam_n - lam_s
        incr = incr + ((d * d).sum(-1)
                       + torch.diagonal(P_n, dim1=-2, dim2=-1).sum(-1)
                       + torch.diagonal(P_s, dim1=-2, dim2=-1).sum(-1)
                       - 2.0 * torch.diagonal(P_lag, dim1=-2,
                                              dim2=-1).sum(-1))
        lam_sm[t], P_sm[t] = lam_s, P_s
        lam_n, P_n = lam_s, P_s
    return lam_sm, P_sm, incr


def loading_smoother(lam_f, P_f, tau2):
    """The reverse loading scan: kernel K11-bwd (``csrc/tv_loadings.cu``)
    for CUDA tensors (``loading_smoother_gen`` at 16 < k <= 128)."""
    if lam_f.device.type == "cpu":
        return loading_smoother_plain(lam_f, P_f, tau2)
    T, N, k = lam_f.shape
    dt, dev = lam_f.dtype, lam_f.device
    kernel = _kernel("loading_smoother", k,
                     [("lam_f", lam_f, (T, N, k)), ("P_f", P_f, (T, N, k, k)),
                      ("tau2", tau2, (N,))], dt, dev)
    lam_sm = torch.empty((T, N, k), dtype=dt, device=dev)
    P_sm = torch.empty((T, N, k, k), dtype=dt, device=dev)
    incr = torch.empty((N,), dtype=dt, device=dev)
    if kernel == "loading_smoother":
        kernels.launch(kernel, dt, lam_f, P_f, tau2, lam_sm, P_sm, incr, T,
                       N, k)
    else:
        work, slots = _smoother_work(k, N, dt, dev)
        kernels.launch(kernel, dt, lam_f, P_f, tau2, lam_sm, P_sm, incr,
                       work, T, N, k, slots)
    return lam_sm, P_sm, incr


def loading_pass_plain(Y, F, p: TVLParams, mask=None):
    """``loading_pass`` through the plain twins."""
    lam_f, P_f = loading_filter_plain(Y, F, p.Lam0, p.tau2, p.R, mask)
    return loading_smoother_plain(lam_f, P_f, p.tau2)


def loading_pass(Y, F, p: TVLParams, mask=None):
    """N independent k-dim random-walk chains given the factor path F:
    K11-fwd then K11-bwd.  Returns (lam_sm (T, N, k), P_sm (T, N, k, k),
    incr (N,)), incr the summed E|lam_t - lam_t-1|^2 of the tau2 update."""
    lam_f, P_f = loading_filter(Y, F, p.Lam0, p.tau2, p.R, mask)
    return loading_smoother(lam_f, P_f, p.tau2)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def tvl_round_core(Y, mask, Lam_t, p: TVLParams, spec: TVLSpec,
                   reduce_tree=None):
    """One alternation round: (Lam_t', params', loglik (f64, at the
    entering state), F_sm).  ``Y`` is zero-filled at missing entries when
    ``mask`` is given.  The residual and smear contractions are batched
    products over the step axis, with no (T, N, k, k) temporary beyond
    the smoothed loading covariances.  ``reduce_tree`` raises when given
    (ROADMAP Queue 1 item 12)."""
    refuse_unported("tvl_round_core", ("reduce_tree", reduce_tree is not None,
                                       12))
    T, N = Y.shape
    k = spec.n_factors
    kf, sm = factor_pass_tv(Y, Lam_t, p, mask)
    F = sm.x_sm

    # Factor-dynamics M-bits (exact given the factor smoother).
    EffT, cross = moments(sm)
    S_lag = EffT[:-1].sum(0)
    S_cur = EffT[1:].sum(0)
    S_cross = cross.sum(0)
    A = solve_psd(S_lag, S_cross.T).T
    Q = sym((S_cur - A @ S_cross.T) / (T - 1))

    # B-step: loadings given the smoothed-mean factor path.
    lam_sm, P_sm_l, incr = loading_pass(Y, F, p, mask)

    # R update: conditional residuals + loading-uncertainty smear.
    fit = torch.bmm(lam_sm, F[:, :, None])[..., 0]                # (T, N)
    FF = (F[:, :, None] * F[:, None, :]).reshape(T, k * k, 1)
    quad = torch.bmm(P_sm_l.reshape(T, N, k * k), FF)[..., 0]      # (T, N)
    Yz = torch.nan_to_num(Y)
    if mask is None:
        resid = Yz - fit
        smear = quad.sum(0)
        counts = float(max(T, 1))
    else:
        W = mask.to(Y.dtype)
        resid = Yz * W - W * fit
        smear = (W * quad).sum(0)
        counts = torch.clamp(W.sum(0), min=1.0)
    R = torch.clamp((torch.einsum("tn,tn->n", resid, resid) + smear) / counts,
                    min=spec.r_floor)

    tau2 = p.tau2
    if spec.estimate_tau2:
        tau2 = torch.clamp(incr / ((T - 1) * k), min=spec.tau2_floor)

    p_new = TVLParams(*(x.contiguous() for x in (lam_sm[0], tau2, A, Q, R,
                                                 p.mu0, p.P0)))
    return lam_sm, p_new, kf.loglik, F


def _rounds(Y, mask, Lam_t, p: TVLParams, spec: TVLSpec, n: int):
    """n rounds with no host read: (the (Lam_t, params) state after each,
    logliks (n,) f64 on Y's device at each round's entering state)."""
    states, lls = [], []
    for _ in range(n):
        Lam_t, p, ll, _ = tvl_round_core(Y, mask, Lam_t, p, spec)
        states.append((Lam_t, p))
        lls.append(ll)
    return states, torch.stack(lls) if lls else torch.zeros(
        (0,), dtype=torch.float64, device=Y.device)


def tvl_round_scan(Y, mask, Lam_t, p: TVLParams, spec: TVLSpec,
                   has_mask: bool, n_rounds: int):
    """``n_rounds`` alternation rounds as eager device work with no host
    read: ((Lam_t', params'), logliks (n,) f64).  The JAX signature:
    ``mask`` is used only when ``has_mask``."""
    states, lls = _rounds(Y, mask if has_mask else None, Lam_t, p, spec,
                          n_rounds)
    return (states[-1] if states else (Lam_t, p)), lls


def tvl_loglik_eval(Y, Lam_t, p: TVLParams, mask=None,
                    precise: bool = True, device=None) -> float:
    """Reporting-grade CONDITIONAL log-likelihood p(Y | Lam_{1:T}, theta)
    at (Lam_t, params).  ``precise`` evaluates it in float64 (K2-tv, K4 and
    K1-tv in f64 on a card), else in Lam_t's dtype.  The device is Lam_t's
    when it is a tensor, else ``device`` (default "cuda").  Inputs may be
    NumPy or tensors; NaN in Y counts as zero (pass the mask)."""
    if isinstance(Lam_t, torch.Tensor):
        dev = Lam_t.device
        dtype = torch.float64 if precise else Lam_t.dtype
    else:
        dev = torch.device(device or "cuda")
        dtype = torch.float64 if precise else torch.float32
    with highest_precision():
        Yt = torch.nan_to_num(torch.as_tensor(Y).to(dev, dtype)).contiguous()
        Lt = torch.as_tensor(Lam_t).to(dev, dtype).contiguous()
        pt = TVLParams(*p).to(dev, dtype)
        mt = (torch.as_tensor(mask).to(dev, dtype).contiguous()
              if mask is not None else None)
        return float(_tv_filter(Yt, Lt, pt, mt).loglik)


def _tvl_factors(Y, mask, Lam_t, p: TVLParams):
    """Smoothed factor path at fixed (Lam_t, params), the reporting pass:
    K2-tv and the K4 pair (the loglik's K1-tv is not needed)."""
    stats = obs_stats_tv(Y, Lam_t, p.R, mask)
    xp, Pp, xf, Pf, _ = info_scan(stats, p.A, p.Q, p.mu0, p.P0)
    kf = FilterResult(xp, Pp, xf, Pf, None)
    return _smooth(kf, Lam_t, p).x_sm


@dataclasses.dataclass
class TVLResult:
    params: TVLParams          # NumPy float64 fields
    loadings: np.ndarray       # (T, N, k) smoothed loading paths
    factors: np.ndarray        # (T, k)
    logliks: np.ndarray        # conditional loglik per round
    common: np.ndarray         # (T, N) fitted common component
    converged: bool
    spec: TVLSpec
    health: object = None      # robust.FitHealth trace record

    @property
    def loglik(self):
        return float(self.logliks[-1]) if len(self.logliks) else float("nan")


def tvl_forecast(result: TVLResult, horizon: int):
    """h-step out-of-sample forecast: loadings frozen at their end-of-sample
    smoothed value Lam_T (the random walk's conditional mean), the factor
    VAR(1) iterated from the last estimated factor state.  Returns
    (y_fore (h, N), f_fore (h, k)) in the units ``tvl_fit`` saw."""
    A = np.asarray(result.params.A, np.float64)
    Lam_T = np.asarray(result.loadings[-1], np.float64)     # (N, k)
    f = np.zeros((horizon, A.shape[0]))
    x = np.asarray(result.factors[-1], np.float64)
    for h in range(horizon):
        x = A @ x
        f[h] = x
    return f @ Lam_T.T, f


def tvl_fit(Y: np.ndarray, spec: TVLSpec,
            mask: Optional[np.ndarray] = None,
            dtype=None, callback=None,
            init: Optional[TVLParams] = None,
            fused_chunk: int = 8, device="cuda") -> TVLResult:
    """Dual-Kalman alternating estimation of the TVL-DFM.

    Warm start: static PCA (``backends.cpu_ref.pca_init``, loadings
    constant), tau2 = 1e-4; then ``spec.n_rounds`` alternation rounds (or
    until the conditional loglik's relative change drops below
    ``spec.tol``), ``fused_chunk`` rounds a chunk with one blocking read
    each (``estim.em.run_chunked``: the JAX package's stop rule, monotone,
    with the state of the update count it selects).  The reported factor
    path is a final A-pass at the final (Lam_t, params) state, read back
    with the loadings and params in one read (``estim.fused.read_packed``).

    device: "cuda" (the default: the kernels) or "cpu" (the plain twins).
    dtype: None for float32 on CUDA and float64 on the CPU.  ``init``: a
    ``TVLParams`` of tensors or arrays.  ``callback`` is not ported yet.
    """
    if callback is not None:
        raise NotImplementedError(
            "tvl_fit(callback=) is not ported to dfm_tpu_torch yet: ROADMAP "
            "Queue 1 item 3 (the fit() options)")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tvl_fit(device='cuda'): no CUDA device is available; pass "
            "device='cpu' to run the plain-torch path")
    dtype = default_compute_dtype(dev) if dtype is None else dtype
    Y = np.asarray(Y, np.float64)
    T, N = Y.shape
    k = spec.n_factors
    W = build_mask(Y)
    if mask is not None:
        W = W * np.asarray(mask, np.float64)
    any_missing = bool((W == 0).any())
    Yz = np.where(W > 0, np.nan_to_num(Y), 0.0)
    if init is None:
        p0 = pca_init(Yz, k, mask=W if any_missing else None)
        init = TVLParams(Lam0=p0.Lam, tau2=np.full((N,), 1e-4), A=p0.A,
                         Q=p0.Q, R=p0.R, mu0=p0.mu0, P0=p0.P0)
    with highest_precision():
        p = TVLParams(*init).to(dev, dtype)
        Yt = torch.as_tensor(Yz, dtype=dtype, device=dev).contiguous()
        Wt = (torch.as_tensor(W, dtype=dtype, device=dev).contiguous()
              if any_missing else None)
        Lam_t = p.Lam0.expand(T, N, k).contiguous()
        floor = noise_floor_for(dtype, Yt.numel())
        (Lam_t, p), lls, converged, _, _, _ = run_chunked(
            lambda s, n: (*_rounds(Yt, Wt, s[0], s[1], spec, n), None),
            (Lam_t, p), spec.n_rounds, spec.tol, floor, fused_chunk)
        F = _tvl_factors(Yt, Wt, Lam_t, p)
        out = _fused.read_packed({"loadings": Lam_t, "factors": F,
                                  **p._asdict()})
    Lam_np, F_np = out["loadings"], out["factors"]
    return TVLResult(params=TVLParams(*(out[f] for f in TVLParams._fields)),
                     loadings=Lam_np, factors=F_np, logliks=lls,
                     common=np.einsum("tnk,tk->tn", Lam_np, F_np),
                     converged=converged, spec=spec,
                     health=health_from_trace(lls, floor))
