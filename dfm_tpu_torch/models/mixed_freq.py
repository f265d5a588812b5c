"""Mixed-frequency nowcasting DFM (config S3, BASELINE.json:9).

The PyTorch twin of ``dfm_tpu.models.mixed_freq``.  A monthly/quarterly
panel with arbitrary missing observations:

- State augmentation (Mariano-Murasawa): the state stacks n_lags = 5
  monthly factor lags, x_t = [f_t, f_{t-1}, ..., f_{t-4}], m = L k; the
  quarterly series load on g_t = sum_j w_j f_{t-j}, w = [1,2,3,2,1]/3.
  The transition is the companion matrix with A top-left; only the top
  k x k block of Q is nonzero.
- Missing data: a {0,1} mask; quarterly rows are masked except months 3,
  6, ... and any ragged edge.
- Constrained EM: monthly rows regress on the f_t block, quarterly rows
  on g_t; A and Q from the within-state cross moments E[f_t f_{t-1}'].

One EM iteration (``mf_em_core``) on the card, ``time_scan="seq"``:

  K2-wide (``obs_stats`` on the augmented loadings, masked) -> the
  statistics widened to f64 -> K4-wide forward (``info_scan``) in f64 ->
  x_pred narrowed to the compute dtype -> K1-wide
  (``loglik_terms_local``: quad_R with the f64 sum, U from the residual)
  -> the f64 loglik -> K4-wide backward (``rts_smoother``) in f64 -> the
  M-step in the compute dtype (plain torch: block einsums over the
  (T, L, k, L, k) view, batched k x k solves).

The augmented scans concentrate the whole cross-section's precision on
the m-dim state, so they run in f64: the JAX package upgrades them with
``accum_dtype(dtype, native_only=True)``, f64 where f64 is native, and it
is native on the H100 as on the CPU.  At S3 (m = 25) the K4 pair and K1,
K2 take their wide kernels (K12, 16 < k <= 32); at m <= 16 the K4 pair
and K2 take the k <= 16 kernels, and ``loglik_terms_local`` K1-wide at any
m <= 32.  ``time_scan="lowrank"`` replaces the K4 pair by the rank-r K9
trio (one K9-basis an iteration, shared by both scans);
``time_scan="pit"`` by the covariance-form parallel-in-time pair (K14:
``pit_elements`` and ``pit_scan``, four and two launches an iteration, in
f64 on the augmented statistics; their generic kernels at m > 32), and
``time_scan="pit_qr"`` by the square-root parallel-in-time pair (K8:
``qr_elements`` and ``qr_scan``, four and two launches an iteration, in
f64; at m > 10, S3's m = 25 included, their generic kernels
``qr_elements_gen`` and ``qr_scan_gen``, the JAX package's generic
branches).  ``mf_fit`` and ``mf_loglik_eval`` run
under ``highest_precision()``: reduced-precision products wobble the
augmented statistics enough to fake divergences.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..backends.cpu_ref import _solve_discrete_lyapunov_or_eye, pca_init
from ..estim import fused as _fused
from ..estim.em import noise_floor_for, run_chunked
from ..ops.linalg import solve_psd, sym
from ..ops.precision import (accum_dtype, default_compute_dtype,
                             highest_precision)
from ..robust.health import health_from_trace
from ..ssm.info_filter import (ObsStats, info_scan, loglik_eval,
                               loglik_from_terms, loglik_terms_local,
                               obs_stats)
from ..ssm.kalman import rts_smoother
from ..ssm.lowrank_filter import (lowrank_from_stats,
                                  lowrank_loglik_from_terms,
                                  lowrank_smoother, policy_basis,
                                  resolve_rank)
from ..ssm.parallel_filter import (pit_from_stats, pit_qr_from_stats,
                                   pit_qr_smoother, pit_smoother)
from ..ssm.params import FilterResult, SmootherResult, SSMParams
from ..utils import refuse_unported
from ..utils.data import build_mask, standardize as _standardize

__all__ = ["MixedFreqSpec", "MFParams", "augment", "mf_em_core",
           "mf_em_step", "mf_em_scan", "mf_fit", "mf_forecast",
           "mf_loglik_eval", "mf_pca_init", "MFResult"]

MM_WEIGHTS = (1.0 / 3, 2.0 / 3, 1.0, 2.0 / 3, 1.0 / 3)


@dataclasses.dataclass(frozen=True)
class MixedFreqSpec:
    """Static model description.  ``time_scan``: "seq" (the filter and RTS
    pair, the default), "pit" (the covariance-form parallel-in-time pair),
    "pit_qr" (the square-root parallel-in-time pair) or "lowrank" (the
    rank-r scans at ``rank``, <= 0 for min(m, 8))."""
    n_monthly: int
    n_quarterly: int
    n_factors: int
    n_lags: int = 5
    weights: tuple = MM_WEIGHTS
    r_floor: float = 1e-6
    estimate_init: bool = False
    time_scan: str = "seq"
    rank: int = 0

    def __post_init__(self):
        if self.time_scan not in ("seq", "pit", "pit_qr", "lowrank"):
            raise ValueError(
                f"time_scan must be 'seq', 'pit', 'pit_qr' or 'lowrank'; "
                f"got {self.time_scan!r}")

    @property
    def state_dim(self) -> int:
        return self.n_lags * self.n_factors


class MFParams(NamedTuple):
    """The small (unaugmented) parameters the EM iterates on: Lam_m (Nm,
    k), Lam_q (Nq, k) on g_t, A, Q (k, k), R (Nm + Nq,), mu0 (m,), P0
    (m, m) the augmented state's initial moments."""

    Lam_m: torch.Tensor
    Lam_q: torch.Tensor
    A: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    mu0: torch.Tensor
    P0: torch.Tensor

    def to(self, device=None, dtype=None) -> "MFParams":
        """Each field as a contiguous tensor on ``device`` in ``dtype``
        (fields may be tensors or NumPy arrays)."""
        return MFParams(*(torch.as_tensor(x).to(device=device, dtype=dtype)
                          .contiguous() for x in self))

    @classmethod
    def from_numpy(cls, p, dtype=torch.float64, device="cpu") -> "MFParams":
        """From any object with the seven fields as arrays (the JAX
        package's ``MFParams`` included)."""
        return cls(*(torch.tensor(np.asarray(getattr(p, f)), dtype=dtype,
                                  device=device).contiguous()
                     for f in cls._fields))

    def to_numpy(self) -> "MFParams":
        """The same fields as NumPy float64 arrays."""
        return MFParams(*(torch.as_tensor(x).detach().to("cpu",
                                                           torch.float64)
                          .numpy() for x in self))


@functools.lru_cache(maxsize=16)
def _weights(weights: tuple, dtype, device) -> torch.Tensor:
    """The MM weights as a tensor, made once per (weights, dtype, device):
    a blocking host->device copy inside an iteration would read as a sync."""
    return torch.tensor(weights, dtype=dtype, device=device)


def augment(p: MFParams, spec: MixedFreqSpec) -> SSMParams:
    """The augmented (state dim m = L k) ``SSMParams`` of the filter, on
    p's device in p's dtype: monthly rows on block 0, quarterly rows
    kron(w, lam_q), the companion transition, Q in the top block."""
    k, m = spec.n_factors, spec.state_dim
    dt, dev = p.Lam_m.dtype, p.Lam_m.device
    wv = _weights(spec.weights, dt, dev)
    Lam_m_aug = torch.cat(
        [p.Lam_m, torch.zeros((spec.n_monthly, m - k), dtype=dt,
                              device=dev)], dim=1)
    Lam_q_aug = (wv[None, :, None] * p.Lam_q[:, None, :]).reshape(
        spec.n_quarterly, m)
    Lam = torch.cat([Lam_m_aug, Lam_q_aug], dim=0).contiguous()
    A_aug = torch.zeros((m, m), dtype=dt, device=dev)
    A_aug[:k, :k] = p.A
    A_aug[k:, :m - k] = torch.eye(m - k, dtype=dt, device=dev)
    Q_aug = torch.zeros((m, m), dtype=dt, device=dev)
    Q_aug[:k, :k] = p.Q
    return SSMParams(Lam=Lam, A=A_aug, Q=Q_aug, R=p.R, mu0=p.mu0, P0=p.P0)


def _e_step(Y, mask, p: MFParams, spec: MixedFreqSpec):
    """The E-step: (FilterResult with the entry loglik, the f64
    SmootherResult).  See the module docstring for the kernels and the
    dtypes."""
    dtype = Y.dtype
    acc = accum_dtype()
    aug = augment(p, spec)
    stats = obs_stats(Y, aug.Lam, aug.R, mask=mask)
    aug_acc = aug.to(dtype=acc)
    stats_acc = ObsStats(*(s.to(acc) for s in stats))
    if spec.time_scan == "lowrank":
        V = policy_basis(aug_acc.Lam, aug_acc.R,
                         resolve_rank(spec.state_dim, spec.rank))
        xp, Pp, xf, Pf, logdetG, corr = lowrank_from_stats(
            stats_acc, aug_acc, spec.rank, V)
    elif spec.time_scan == "pit":
        xp, Pp, xf, Pf, logdetG = pit_from_stats(stats_acc, aug_acc)
    elif spec.time_scan == "pit_qr":
        xp, Pp, xf, Pf, logdetG = pit_qr_from_stats(stats_acc, aug_acc)
    else:
        xp, Pp, xf, Pf, logdetG = info_scan(stats_acc, aug_acc.A, aug_acc.Q,
                                            aug_acc.mu0, aug_acc.P0)
    quad_R, U = loglik_terms_local(Y, aug.Lam, aug.R, xp.to(dtype), mask)
    if spec.time_scan == "lowrank":
        # The rank-r scan's quad correction replaces u'P_f u.
        ll = lowrank_loglik_from_terms(stats_acc, logdetG, corr, quad_R)
    else:
        ll = loglik_from_terms(stats_acc, logdetG, Pf, quad_R, U.to(acc))
    kf = FilterResult(xp, Pp, xf, Pf, ll)
    if spec.time_scan == "lowrank":
        sm = lowrank_smoother(kf, aug_acc, spec.rank, V)
    elif spec.time_scan == "pit":
        sm = pit_smoother(kf, aug_acc)
    elif spec.time_scan == "pit_qr":
        sm = pit_qr_smoother(kf, aug_acc)
    else:
        sm = rts_smoother(kf, aug_acc)
    return kf, sm


def _m_step(Y, mask, p: MFParams, spec: MixedFreqSpec,
            sm: SmootherResult) -> MFParams:
    """The constrained M-step in Y's dtype (the JAX body, expanded R)."""
    k, L, Nm = spec.n_factors, spec.n_lags, spec.n_monthly
    dtype, dev = Y.dtype, Y.device
    T = Y.shape[0]
    wv = _weights(spec.weights, dtype, dev)
    eye = torch.eye(k, dtype=dtype, device=dev)
    x, P = sm.x_sm.to(dtype), sm.P_sm.to(dtype)      # (T, m), (T, m, m)
    EffT = P + torch.einsum("ti,tj->tij", x, x)
    E5 = EffT.reshape(T, L, k, L, k)
    Ef = x.reshape(T, L, k)

    W = mask.to(dtype)
    Yz = torch.where(W > 0, torch.nan_to_num(Y), 0.0)
    counts = torch.clamp(W.sum(0), min=1.0)

    # Monthly loadings: regress on the f_t (block-0) moments.
    Ef0 = Ef[:, 0, :]
    Eff0 = E5[:, 0, :, 0, :]
    Wm, Ym = W[:, :Nm], Yz[:, :Nm]
    S_yf_m = torch.einsum("ti,tk->ik", Ym, Ef0)
    S_ff_m = torch.einsum("ti,tkl->ikl", Wm, Eff0)
    never_m = (Wm.sum(0) == 0)[:, None, None]
    S_ff_m = torch.where(never_m, eye[None], S_ff_m)
    Lam_m = solve_psd(S_ff_m, S_yf_m)
    rm = (torch.einsum("ti,ti->i", Ym, Ym)
          - 2.0 * torch.einsum("ti,ti->i", Ym, Ef0 @ Lam_m.T)
          + torch.einsum("ik,ikl,il->i", Lam_m, S_ff_m, Lam_m))

    # Quarterly loadings: regress on g_t = sum_j w_j f_{t-j}.
    Eg = torch.einsum("tak,a->tk", Ef, wv)
    Egg = torch.einsum("tajbl,a,b->tjl", E5, wv, wv)
    Wq, Yq = W[:, Nm:], Yz[:, Nm:]
    S_yg = torch.einsum("ti,tk->ik", Yq, Eg)
    S_gg = torch.einsum("ti,tkl->ikl", Wq, Egg)
    never_q = (Wq.sum(0) == 0)[:, None, None]
    S_gg = torch.where(never_q, eye[None], S_gg)
    Lam_q = solve_psd(S_gg, S_yg)
    rq = (torch.einsum("ti,ti->i", Yq, Yq)
          - 2.0 * torch.einsum("ti,ti->i", Yq, Eg @ Lam_q.T)
          + torch.einsum("ik,ikl,il->i", Lam_q, S_gg, Lam_q))

    R = torch.clamp(torch.cat([rm, rq]) / counts, min=spec.r_floor)

    # Transition block from the within-state cross moments; t = 0's pair
    # belongs to the prior, hence the [1:] sums.
    S_cur = E5[1:, 0, :, 0, :].sum(0)
    S_cross = E5[1:, 0, :, 1, :].sum(0)
    S_lag = E5[1:, 1, :, 1, :].sum(0)
    A = solve_psd(S_lag, S_cross.T).T
    Q = sym((S_cur - A @ S_cross.T) / (T - 1))

    mu0, P0 = p.mu0, p.P0
    if spec.estimate_init:
        mu0, P0 = x[0], sym(P[0])
    return MFParams(*(v.contiguous() for v in (Lam_m, Lam_q, A, Q, R, mu0,
                                                P0)))


def mf_em_core(Y, mask, p: MFParams, spec: MixedFreqSpec, reduce_tree=None):
    """One constrained EM iteration: (new params, the f64 loglik at the
    entry params, the f64 SmootherResult).  ``Y`` (T, Nm + Nq) zero-filled
    at missing entries, ``mask`` (T, N) in Y's dtype, ``p`` on Y's device
    in Y's dtype.  ``reduce_tree`` (the series-sharded reduction) raises
    when given: ROADMAP Queue 1 item 12."""
    refuse_unported("mf_em_core", ("reduce_tree", reduce_tree is not None,
                                   12))
    kf, sm = _e_step(Y, mask, p, spec)
    return _m_step(Y, mask, p, spec, sm), kf.loglik, sm


def mf_em_step(Y, mask, p: MFParams, spec: MixedFreqSpec):
    """One constrained EM iteration: (new params, entry loglik)."""
    p_new, ll, _ = mf_em_core(Y, mask, p, spec)
    return p_new, ll


def _mf_smooth_impl(Y, mask, p: MFParams, spec: MixedFreqSpec):
    """The filter and smoother at fixed params (no M-step): (x_sm, P_sm,
    loglik), the smoothed moments in f64."""
    kf, sm = _e_step(Y, mask, p, spec)
    return sm.x_sm, sm.P_sm, kf.loglik


def _iters(Y, mask, p: MFParams, spec: MixedFreqSpec, n: int):
    """n EM iterations with no host read: (the params after each, a list;
    logliks (n,) f64 at each iteration's entry params)."""
    states, lls = [], []
    for _ in range(n):
        p, ll = mf_em_step(Y, mask, p, spec)
        states.append(p)
        lls.append(ll)
    return states, (torch.stack(lls) if lls else torch.zeros(
        (0,), dtype=torch.float64, device=Y.device))


def mf_em_scan(Y, mask, p: MFParams, spec: MixedFreqSpec, n_iters: int):
    """``n_iters`` EM iterations as eager device work with no host read:
    (params, logliks (n,) f64)."""
    states, lls = _iters(Y, mask, p, spec, n_iters)
    return (states[-1] if states else p), lls


def mf_loglik_eval(Y, mask, p, spec: MixedFreqSpec, precise: bool = True,
                   device=None) -> float:
    """Reporting-grade log-likelihood at given params (the loglik contract
    of BASELINE.json:5 for S3).  ``precise``: the augmented params (built
    in f64) through the masked info-form filter in f64 (``loglik_eval``);
    else the fit's own E-step in Y's dtype, an all-ones mask when ``mask``
    is None.  ``Y`` zero-filled at missing entries; Y, mask and p may be
    NumPy or tensors; the device is Y's when Y is a tensor, else
    ``device`` (default "cuda")."""
    dev = (Y.device if isinstance(Y, torch.Tensor)
           else torch.device(device or "cuda"))
    with highest_precision():
        if precise:
            aug = augment(MFParams(*p).to(dev, torch.float64), spec)
            return loglik_eval(Y, aug, mask=mask, precise=True, device=dev)
        Yt = torch.as_tensor(Y).to(dev).contiguous()
        dtype = Yt.dtype
        mt = (torch.as_tensor(mask).to(dev, dtype).contiguous()
              if mask is not None else torch.ones_like(Yt))
        _, ll = mf_em_step(Yt, mt, MFParams(*p).to(dev, dtype), spec)
        return float(ll)


def mf_pca_init(Y: np.ndarray, mask: np.ndarray,
                spec: MixedFreqSpec) -> MFParams:
    """Warm start on the host: PCA on the zero-filled monthly block, then
    OLS of the observed quarterly values on the MM-aggregated factor path.
    Returns NumPy float64 fields."""
    k, L, Nm = spec.n_factors, spec.n_lags, spec.n_monthly
    wv = np.asarray(spec.weights, np.float64)
    T = Y.shape[0]
    W = np.asarray(mask, np.float64)
    Yz = np.where(W > 0, np.nan_to_num(np.asarray(Y, np.float64)), 0.0)
    pm = pca_init(Yz[:, :Nm], k)
    F = Yz[:, :Nm] @ pm.Lam / Nm                  # (T, k) PCA factor path
    # MM aggregate of the estimated path (zeros before t = 0).
    G = np.zeros((T, k))
    for j in range(L):
        G[j:] += wv[j] * F[: T - j]
    Lam_q = np.zeros((spec.n_quarterly, k))
    Wq, Yq = W[:, Nm:], Yz[:, Nm:]
    for i in range(spec.n_quarterly):
        w = Wq[:, i] > 0
        if w.sum() > k:
            Lam_q[i] = np.linalg.lstsq(G[w], Yq[w, i], rcond=None)[0]
    resid_q = Yq - G @ Lam_q.T
    Rq = np.ones(spec.n_quarterly)
    for i in range(spec.n_quarterly):
        w = Wq[:, i] > 0
        Rq[i] = resid_q[w, i].var() if w.sum() > 1 else 1.0
    m = spec.state_dim
    A_aug = np.zeros((m, m))
    A_aug[:k, :k] = pm.A
    A_aug[k:, :-k] = np.eye(m - k)
    Q_aug = np.zeros((m, m))
    Q_aug[:k, :k] = pm.Q
    P0 = _solve_discrete_lyapunov_or_eye(A_aug, Q_aug + 1e-10 * np.eye(m))
    return MFParams(Lam_m=pm.Lam, Lam_q=Lam_q, A=pm.A, Q=pm.Q,
                    R=np.concatenate([pm.R, np.maximum(Rq, 1e-6)]),
                    mu0=np.zeros(m), P0=P0)


@dataclasses.dataclass
class MFResult:
    params: MFParams             # NumPy float64 fields
    logliks: np.ndarray
    factors: np.ndarray          # (T, k) smoothed current-month factors
    factor_cov: np.ndarray       # (T, k, k)
    nowcast: np.ndarray          # (T, N) smoothed common component
    converged: bool
    spec: MixedFreqSpec
    state_T: np.ndarray = None       # (m,) smoothed augmented state at T
    state_cov_T: np.ndarray = None   # (m, m)
    standardizer: object = None      # utils.data.Standardizer or None
    health: object = None            # robust.FitHealth (trace-level)

    @property
    def loglik(self):
        return float(self.logliks[-1]) if len(self.logliks) else float("nan")


def _aug_np(p, spec: MixedFreqSpec) -> SSMParams:
    """``augment`` of NumPy (or any) params, on the CPU in f64."""
    return augment(MFParams(*p).to("cpu", torch.float64), spec)


def mf_forecast(result: MFResult, horizon: int):
    """h-step out-of-sample forecast: the augmented companion state
    iterated from the smoothed end-of-sample state and mapped through the
    Mariano-Murasawa loadings.  Returns (y_fore (h, N) in ORIGINAL data
    units, f_fore (h, k) monthly factors)."""
    if result.state_T is None:
        raise ValueError("MFResult lacks state_T (old result object?)")
    spec = result.spec
    k = spec.n_factors
    aug = _aug_np(result.params, spec)
    A, Lam = aug.A.numpy(), aug.Lam.numpy()
    x = np.asarray(result.state_T, np.float64)
    f = np.zeros((horizon, k))
    y = np.zeros((horizon, Lam.shape[0]))
    for h in range(horizon):
        x = A @ x
        f[h] = x[:k]
        y[h] = Lam @ x
    if result.standardizer is not None:
        y = result.standardizer.inverse(y)
    return y, f


def mf_fit(Y: np.ndarray, spec: MixedFreqSpec,
           mask: Optional[np.ndarray] = None,
           max_iters: int = 50, tol: float = 1e-6,
           dtype=None, init: Optional[MFParams] = None,
           standardize: bool = True,
           callback=None, fused_chunk: int = 8,
           device="cuda") -> MFResult:
    """Estimate the mixed-frequency DFM.  Y is (T, Nm + Nq), monthly series
    first; NaNs and/or ``mask`` mark unobserved entries.  Standardization
    (per series, over observed entries) by default; the nowcast comes back
    in original units.

    EM runs in chunks of ``fused_chunk`` iterations with one blocking read
    each (``estim.em.run_chunked``: the JAX package's monotone stop rule,
    with the params of the iteration count it selects); the reporting
    smooth and the params come back in one packed read.
    ``device``: "cuda" (the kernels) or "cpu" (the plain twins).
    ``dtype``: None for float32 on CUDA and float64 on the CPU.  ``init``:
    an ``MFParams`` of tensors or arrays (None: ``mf_pca_init``).
    ``callback`` is not ported yet.
    """
    if callback is not None:
        raise NotImplementedError(
            "mf_fit(callback=) is not ported to dfm_tpu_torch yet: ROADMAP "
            "Queue 1 item 3 (the fit() options)")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mf_fit(device='cuda'): no CUDA device is available; pass "
            "device='cpu' to run the plain-torch path")
    dtype = default_compute_dtype(dev) if dtype is None else dtype
    Y = np.asarray(Y, np.float64)
    W = build_mask(Y, mask)
    std = None
    if standardize:
        Y, std = _standardize(Y, mask=W)
    if init is None:
        init = mf_pca_init(Y, W, spec)
    with highest_precision():
        Yt = torch.as_tensor(np.nan_to_num(Y * (W > 0)), dtype=dtype,
                             device=dev).contiguous()
        Wt = torch.as_tensor(W, dtype=dtype, device=dev).contiguous()
        p = MFParams(*init).to(dev, dtype)
        floor = noise_floor_for(dtype, Yt.numel())
        p, lls, converged, _, _, _ = run_chunked(
            lambda q, n: (*_iters(Yt, Wt, q, spec, n), None), p, max_iters,
            tol, floor, fused_chunk)
        x_sm, P_sm, _ = _mf_smooth_impl(Yt, Wt, p, spec)
        out = _fused.read_packed({"x_sm": x_sm, "P_sm": P_sm,
                                  **p._asdict()})
    k = spec.n_factors
    x_sm, P_sm = out["x_sm"], out["P_sm"]
    params = MFParams(*(out[f] for f in MFParams._fields))
    common = x_sm @ _aug_np(params, spec).Lam.numpy().T
    if std is not None:
        common = std.inverse(common)
    return MFResult(params=params, logliks=lls, factors=x_sm[:, :k],
                    factor_cov=P_sm[:, :k, :k], nowcast=common,
                    converged=converged, spec=spec, state_T=x_sm[-1],
                    state_cov_T=P_sm[-1], standardizer=std,
                    health=health_from_trace(lls, floor))
