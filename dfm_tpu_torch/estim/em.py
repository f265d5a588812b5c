"""EM estimation for DFMs in PyTorch: E-step, closed-form M-step, and the
chunked driver.

The twin of ``dfm_tpu.estim.em`` for the ``dense``, ``info``, ``ss``
(steady-state), ``pit`` (covariance-form parallel-in-time), ``pit_qr``
(square-root parallel-in-time) and ``lowrank`` (rank-r downdate) engines.
The masked per-series M-step rows are kernel K3 (``csrc/mstep_rows.cu``;
K3-wide for 16 < k <= 32, K3-gen for 32 < k <= 128) on CUDA tensors, with
``mstep_rows_plain`` beside it; the unmasked rows are a GEMM plus one k x k
solve and stay plain torch.  ``n_steps`` runs
the M-step on a capacity-padded panel (the t-masked dynamics of serving
sessions), and ``em_chunk`` is the live-capped chunk of the fused fit.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from functools import partial

import numpy as np
import torch

from .. import kernels
from ..ops.linalg import solve_psd, sym
from ..ops.precision import highest_precision
from ..ssm.info_filter import info_filter
from ..ssm.kalman import kalman_filter, rts_smoother
from ..ssm.lowrank_filter import (lowrank_filter, lowrank_filter_smoother,
                                  lowrank_smoother)
from ..ssm.parallel_filter import (pit_filter, pit_qr_filter,
                                   pit_qr_smoother, pit_smoother)
from ..ssm.params import SmootherResult, SSMParams
from ..ssm.steady import DEFAULT_TAU, ss_filter_smoother
from ..utils import refuse_unported

__all__ = ["EMConfig", "em_step", "em_fit_scan", "em_chunk",
           "run_em_chunked", "fit_em_chunked", "run_chunked", "read_host",
           "em_progress",
           "noise_floor_for",
           "warn_ss_delta", "moments", "moment_sums", "mstep_rows", "mstep_rows_plain", "mstep_dynamics",
           "mstep_dynamics_sums", "mstep_dynamics_tmasked", "cfg_hypers"]

@dataclasses.dataclass(frozen=True)
class EMConfig:
    """EM switches.

    filter: "dense" (N x N innovation covariance, the small-N engine),
    "info" (information form, k x k scan; the N-scalable engine), "ss"
    (steady-state accelerated: ``tau`` exact covariance steps, then frozen
    gains; falls back to "info" when masked or T <= 2 tau + 4), "pit"
    (covariance-form parallel-in-time; k <= 128 on CUDA), "pit_qr"
    (square-root parallel-in-time; k <= 128 on CUDA, past 10 the JAX
    package's Gram-and-Cholesky branches, f64 its dtype there) or
    "lowrank" (rank-r
    computation-aware downdate filter and smoother,
    ``ssm.lowrank_filter``: only r x r factorizations in the scans,
    conservative covariances, exact at rank = k).

    rank: the rank r of "lowrank" (<= 0: auto, min(k, 8)).

    tau: the steady-state horizon of "ss" (``fit`` sizes it with
    ``ssm.steady.auto_tau``).

    q_scale / r_scale / lam_ridge are the tuned M-step hypers: Q <- q_scale
    Q, R <- max(r_scale R, r_floor), and a ridge on the loading normal
    equations.  At the defaults the M-step is plain EM.
    """
    estimate_A: bool = True
    estimate_Q: bool = True
    estimate_init: bool = False
    r_floor: float = 1e-6
    filter: str = "dense"
    tau: int = DEFAULT_TAU
    noise_floor_mult: float = 100.0
    rank: int = 0
    q_scale: float = 1.0
    r_scale: float = 1.0
    lam_ridge: float = 0.0

    def __post_init__(self):
        if self.filter not in ("dense", "info", "ss", "pit", "pit_qr",
                               "lowrank"):
            raise ValueError(f"unknown filter {self.filter!r}")

    def filter_fn(self):
        if self.filter == "lowrank":
            return partial(lowrank_filter, rank=self.rank)
        return {"dense": kalman_filter, "info": info_filter,
                "pit": pit_filter, "pit_qr": pit_qr_filter}[self.filter]

    def smoother_fn(self):
        if self.filter == "lowrank":
            return partial(lowrank_smoother, rank=self.rank)
        return {"pit": pit_smoother,
                "pit_qr": pit_qr_smoother}.get(self.filter, rts_smoother)

    def report_pair(self):
        """Filter and smoother of a reporting smooth at fitted params:
        pit_qr and lowrank through themselves (their smoothed moments are
        their contract), dense through the N x N filter, info, ss and pit
        through the exact info-form pair."""
        if self.filter in ("pit_qr", "lowrank"):
            return self.filter_fn(), self.smoother_fn()
        ff = kalman_filter if self.filter == "dense" else info_filter
        return ff, rts_smoother

    def report_smooth(self, Y, mask, p):
        """The reporting smooth through ``report_pair``: (kf, sm).
        lowrank makes its policy basis once for both passes."""
        if self.filter == "lowrank":
            return lowrank_filter_smoother(Y, p, mask=mask, rank=self.rank)
        ff, sf = self.report_pair()
        kf = ff(Y, p, mask=mask)
        return kf, sf(kf, p)

    def e_step(self, Y, mask, p, sumsq=None):
        """Filter + smoother under the configured engine: (kf, sm, delta),
        with ``delta`` the steady-state freeze diagnostic ("ss") or 0.
        ``sumsq`` (Y*Y, data-constant) feeds the ss loglik quadratic."""
        if self.filter == "ss":
            return ss_filter_smoother(Y, p, tau=self.tau, mask=mask,
                                      sumsq=sumsq)
        zero = torch.zeros((), dtype=Y.dtype, device=Y.device)
        if self.filter == "lowrank":
            return (*lowrank_filter_smoother(Y, p, mask=mask,
                                             rank=self.rank), zero)
        kf = self.filter_fn()(Y, p, mask=mask)
        return kf, self.smoother_fn()(kf, p), zero


def moments(sm: SmootherResult):
    """Smoothed second moments: (EffT (T,k,k), cross (T-1,k,k))."""
    x, P, Pl = sm.x_sm, sm.P_sm, sm.P_lag
    EffT = P + torch.einsum("ti,tj->tij", x, x)
    cross = Pl[1:] + torch.einsum("ti,tj->tij", x[1:], x[:-1])
    return EffT, cross


def moment_sums(sm: SmootherResult):
    """Unmasked M-step moment sums in matmul form:
    (S_ff, S_ff_lag, S_ff_cur, S_cross)."""
    x, P, Pl = sm.x_sm, sm.P_sm, sm.P_lag
    S_ff = P.sum(0) + x.T @ x
    last = P[-1] + torch.outer(x[-1], x[-1])
    first = P[0] + torch.outer(x[0], x[0])
    S_cross = Pl[1:].sum(0) + x[1:].T @ x[:-1]
    return S_ff, S_ff - last, S_ff - first, S_cross


def mstep_rows_plain(Y, mask, Ef, EffT, P_sm, r_floor: float,
                     lam_ridge=None):
    """Plain-torch masked M-step rows: (Lam (N, k), R (N,))."""
    dtype = Y.dtype
    k = Ef.shape[1]
    eye = torch.eye(k, dtype=dtype, device=Y.device)
    W = mask.to(dtype)
    Yz = torch.where(W > 0, torch.nan_to_num(Y), torch.zeros_like(Y))
    S_yf_i = torch.einsum("ti,tk->ik", Yz, Ef)               # (N, k)
    S_ff_i = torch.einsum("ti,tkl->ikl", W, EffT)            # (N, k, k)
    never = (W.sum(0) == 0)[:, None, None]
    S_ff_i = torch.where(never, eye[None], S_ff_i)
    if lam_ridge is not None:
        S_ff_i = S_ff_i + lam_ridge * eye[None]
    Lam = solve_psd(S_ff_i, S_yf_i)
    counts = torch.clamp(W.sum(0), min=1.0)
    resid_sq = torch.einsum("ti,ti->i", W, (Yz - Ef @ Lam.T) ** 2)
    PV = torch.einsum("ti,tkl->ikl", W, P_sm)
    smear = torch.einsum("ik,ikl,il->i", Lam, PV, Lam)
    R = (resid_sq + smear) / counts
    return Lam, torch.clamp(R, min=r_floor)


def _mstep_rows_masked(Y, mask, Ef, EffT, P_sm, r_floor, lam_ridge):
    if Y.device.type == "cpu":
        return mstep_rows_plain(Y, mask, Ef, EffT, P_sm, r_floor, lam_ridge)
    T, N = Y.shape
    k = Ef.shape[1]
    dt, dev = Y.dtype, Y.device
    kernel = kernels.route("mstep_rows", k)
    for name, x, shape in (("Y", Y, (T, N)), ("mask", mask, (T, N)),
                           ("Ef", Ef, (T, k)), ("EffT", EffT, (T, k, k)),
                           ("P_sm", P_sm, (T, k, k))):
        kernels.check_tensor(name, x, shape, dt, dev)
    Lam = torch.empty((N, k), dtype=dt, device=dev)
    R = torch.empty((N,), dtype=dt, device=dev)
    kernels.launch(kernel, dt, Y, mask, Ef, EffT, P_sm, Lam, R, T, N,
                   k, float(r_floor),
                   0.0 if lam_ridge is None else float(lam_ridge))
    return Lam, R


def mstep_rows(Y, mask, Ef, EffT, P_sm, S_ff, r_floor: float, Ysq=None,
               lam_ridge=None):
    """Per-series M-step rows: new (Lam (N, k), R (N,)).

    Unmasked: S_yf = Y'E[f], one k x k solve, R from the hoisted ``Ysq``.
    Masked: kernel K3 for CUDA tensors (K3-wide for 16 < k <= 32, K3-gen
    for 32 < k <= 128).
    ``lam_ridge`` (optional) solves (S_ff + lam I) instead of S_ff.
    """
    if mask is not None:
        return _mstep_rows_masked(Y, mask, Ef, EffT, P_sm, r_floor,
                                  lam_ridge)
    T = Y.shape[0]
    S_yf = Y.T @ Ef                                           # (N, k)
    if Ysq is None:
        Ysq = torch.einsum("ti,ti->i", Y, Y)
    if lam_ridge is None:
        Lam = solve_psd(S_ff, S_yf.T).T
        R = (Ysq - torch.einsum("ik,ik->i", Lam, S_yf)) / T
    else:
        k = S_ff.shape[0]
        eye = torch.eye(k, dtype=Y.dtype, device=Y.device)
        Lam = solve_psd(S_ff + lam_ridge * eye, S_yf.T).T
        R = (Ysq - 2.0 * torch.einsum("ik,ik->i", Lam, S_yf)
             + torch.einsum("ik,kl,il->i", Lam, S_ff, Lam)) / T
    return Lam, torch.clamp(R, min=r_floor)


def mstep_dynamics_sums(sm: SmootherResult, S_ff_lag, S_ff_cur, S_cross,
                        p: SSMParams, cfg: EMConfig, n_steps=None):
    """k x k M-step updates (A, Q, mu0, P0) from SUMMED moments.

    ``n_steps`` (optional): the live length of a capacity-padded panel
    (sessions); the transition-count divisor becomes ``n_steps - 1``
    instead of ``T - 1``."""
    T = sm.x_sm.shape[0] if n_steps is None else n_steps
    A, Q = p.A, p.Q
    if cfg.estimate_A:
        A = solve_psd(S_ff_lag, S_cross.T).T
        if cfg.estimate_Q:
            Q = sym((S_ff_cur - A @ S_cross.T) / (T - 1))
    elif cfg.estimate_Q:
        Q = sym((S_ff_cur - A @ S_cross.T - S_cross @ A.T
                 + A @ S_ff_lag @ A.T) / (T - 1))
    mu0, P0 = p.mu0, p.P0
    if cfg.estimate_init:
        mu0 = sm.x_sm[0]
        P0 = sym(sm.P_sm[0])
    return A, Q, mu0, P0


def mstep_dynamics(sm: SmootherResult, EffT, cross, p: SSMParams,
                   cfg: EMConfig):
    """k x k M-step updates (A, Q, mu0, P0) from smoother moments."""
    return mstep_dynamics_sums(sm, EffT[:-1].sum(0), EffT[1:].sum(0),
                               cross.sum(0), p, cfg)


def mstep_dynamics_tmasked(sm: SmootherResult, EffT, cross, p: SSMParams,
                           cfg: EMConfig, n_steps):
    """``mstep_dynamics`` for a capacity-padded panel whose first
    ``n_steps`` rows are live: the transition sums become {0,1}-weighted
    reductions (the pad rows' moments contribute exact zeros) with the
    divisor ``n_steps - 1``.  ``n_steps`` is a host integer or a 0-d
    integer tensor."""
    Tc = EffT.shape[0]
    t_idx = torch.arange(Tc, device=EffT.device)
    w_lag = (t_idx < n_steps - 1).to(EffT.dtype)
    w_cur = ((t_idx >= 1) & (t_idx < n_steps)).to(EffT.dtype)
    w_x = (t_idx[:-1] < n_steps - 1).to(EffT.dtype)
    S_lag = torch.einsum("t,tkl->kl", w_lag, EffT)
    S_cur = torch.einsum("t,tkl->kl", w_cur, EffT)
    S_cross = torch.einsum("t,tkl->kl", w_x, cross)
    return mstep_dynamics_sums(sm, S_lag, S_cur, S_cross, p, cfg,
                               n_steps=n_steps)


def cfg_hypers(cfg: EMConfig):
    """(q_scale, r_scale, lam_ridge) from ``cfg``, or ``None`` at the
    defaults (plain EM)."""
    if cfg.q_scale != 1.0 or cfg.r_scale != 1.0 or cfg.lam_ridge != 0.0:
        return (cfg.q_scale, cfg.r_scale, cfg.lam_ridge)
    return None


def _m_step(Y, mask, sm: SmootherResult, p: SSMParams, cfg: EMConfig,
            Ysq=None, n_steps=None) -> SSMParams:
    """Closed-form M-step; returns contiguous params (the kernels take
    contiguous tensors only).  ``n_steps``: the live length of a
    capacity-padded (masked) panel, for the t-masked dynamics."""
    hy = cfg_hypers(cfg)
    ridge = None if hy is None else hy[2]
    if mask is None:
        if n_steps is not None:
            raise ValueError("n_steps (capacity-padded panels) requires a "
                             "mask: the pad tail must be zero-masked")
        S_ff, S_lag, S_cur, S_cross = moment_sums(sm)
        Lam, R = mstep_rows(Y, None, sm.x_sm, None, None, S_ff, cfg.r_floor,
                            Ysq=Ysq, lam_ridge=ridge)
        A, Q, mu0, P0 = mstep_dynamics_sums(sm, S_lag, S_cur, S_cross, p, cfg)
    else:
        EffT, cross = moments(sm)
        Lam, R = mstep_rows(Y, mask, sm.x_sm, EffT, sm.P_sm, None,
                            cfg.r_floor, lam_ridge=ridge)
        if n_steps is None:
            A, Q, mu0, P0 = mstep_dynamics(sm, EffT, cross, p, cfg)
        else:
            A, Q, mu0, P0 = mstep_dynamics_tmasked(sm, EffT, cross, p, cfg,
                                                   n_steps)
    if hy is not None:
        Q = hy[0] * Q
        R = torch.clamp(hy[1] * R, min=cfg.r_floor)
    return SSMParams(*(x.contiguous() for x in (Lam, A, Q, R, mu0, P0)))


def _panel_consts(Y, has_mask: bool, cfg: EMConfig):
    """EM-iteration-invariant panel reductions, computed once per fit:
    (sumsq (T, N) | None, Ysq (N,) | None).  ``sumsq`` = Y*Y feeds the ss
    loglik quadratic, ``Ysq`` the unmasked M-step rows."""
    if has_mask:
        return None, None
    if cfg.filter == "ss":
        sumsq = Y * Y
        return sumsq, sumsq.sum(dim=0)
    return None, torch.einsum("ti,ti->i", Y, Y)


def em_step(Y, p: SSMParams, mask=None, cfg: EMConfig = EMConfig(),
            consts=None, n_steps=None):
    """One EM iteration: (new params, loglik at the entering params as a
    0-d f64 tensor on Y's device, the ss freeze delta as a 0-d tensor).
    ``consts``: ``_panel_consts`` of this panel, computed here if None.
    ``n_steps``: live length of a capacity-padded panel (see ``_m_step``)."""
    sumsq, Ysq = (_panel_consts(Y, mask is not None, cfg) if consts is None
                  else consts)
    kf, sm, delta = cfg.e_step(Y, mask, p, sumsq=sumsq)
    return (_m_step(Y, mask, sm, p, cfg, Ysq=Ysq, n_steps=n_steps),
            kf.loglik, delta)


def em_fit_scan(Y, p0: SSMParams, n_iters: int, mask=None,
                cfg: EMConfig = EMConfig(), consts=None, n_steps=None,
                with_metrics: bool = False, n_active=None):
    """``n_iters`` EM iterations with no host read (``n_steps`` as in
    ``em_step``).

    Returns (params after every update, a list of length ``n_iters``; the
    logliks (n_iters,) at the entering params, an f64 tensor on Y's
    device; the ss freeze deltas (n_iters,) in Y's dtype).  The JAX
    keywords ``with_metrics`` (ROADMAP Queue 1 item 3) and ``n_active``
    (item 4; ``em_chunk`` takes a host cap) raise when given.
    """
    refuse_unported("em_fit_scan", ("with_metrics", bool(with_metrics), 3),
                    ("n_active", n_active is not None, 4))
    if consts is None:
        consts = _panel_consts(Y, mask is not None, cfg)
    ps, lls, deltas = [], [], []
    p = p0
    for _ in range(n_iters):
        p, ll, delta = em_step(Y, p, mask=mask, cfg=cfg, consts=consts,
                               n_steps=n_steps)
        ps.append(p)
        lls.append(ll)
        deltas.append(delta)
    return ps, torch.stack(lls), torch.stack(deltas)


def em_chunk(Y, p: SSMParams, chunk: int, n_active: int, mask=None,
             cfg: EMConfig = EMConfig(), consts=None, n_steps=None):
    """One ``chunk``-iteration EM chunk with a live cap, the twin of the
    JAX package's ``_em_chunk_body`` scanned ``chunk`` times: (params
    after the chunk, logliks (chunk,) f64 at each iteration's entering
    params).  Iterations at index >= ``n_active`` leave the params
    unchanged; ``n_active`` is a host integer here, so they do not run,
    and their loglik slots hold NaN (the fused stop rule masks them out).
    No host read."""
    n_active = max(0, min(int(chunk), int(n_active)))
    lls = torch.full((chunk,), float("nan"), dtype=torch.float64,
                     device=Y.device)
    if n_active == 0:
        return p, lls
    ps, run, _ = em_fit_scan(Y, p, n_active, mask=mask, cfg=cfg,
                             consts=consts, n_steps=n_steps)
    lls[:n_active] = run.to(torch.float64)
    return ps[-1], lls


def em_progress(lls, tol: float, noise_floor: float = 0.0,
                monotone: bool = True) -> str:
    """Classify the last loglik step: 'continue' | 'converged' | 'diverged'.

    |relative change| < tol -> converged.  A drop within ``noise_floor``
    (an ABSOLUTE loglik tolerance, see ``noise_floor_for``) means numerical
    convergence; a larger drop is divergence.  tol <= 0 runs the whole
    budget: only a genuine divergence stops it.  monotone=False (tuned
    updates) classifies a drop as converged.
    """
    if len(lls) < 2:
        return "continue"
    rel = (lls[-1] - lls[-2]) / max(abs(lls[-2]), 1e-12)
    if tol > 0 and abs(rel) < tol:
        return "converged"
    drop = lls[-2] - lls[-1]
    if drop > noise_floor and monotone:
        return "diverged"
    if drop > 0 and tol > 0:
        return "converged"      # noise-floor drop at a plateau
    return "continue"


def warn_ss_delta(max_delta: float, tau: int, threshold: float = 1e-4):
    """Warn when the steady-state freeze error is large enough to bias EM
    (the delta ``ss_filter_smoother`` reports)."""
    if max_delta > threshold:
        warnings.warn(
            f"steady-state filter freeze error {max_delta:.2e} exceeds "
            f"{threshold:.0e} at tau={tau}; EM moments may be biased — "
            "raise EMConfig.tau or use filter='info'", RuntimeWarning,
            stacklevel=3)


def noise_floor_for(dtype, n_obs: float = 1.0, mult: float = 100.0) -> float:
    """ABSOLUTE loglik noise floor for a compute dtype: ``mult`` * eps *
    n_obs, since the loglik is assembled from pieces of magnitude O(n_obs)
    whatever its own magnitude."""
    return mult * float(torch.finfo(dtype).eps) * max(n_obs, 1.0)


def read_host(x: torch.Tensor) -> np.ndarray:
    """The blocking device->host read of a ``run_chunked`` chunk."""
    return x.cpu().numpy()


def run_chunked(scan_fn, state0, max_iters: int, tol: float,
                noise_floor: float, fused_chunk: int = 8,
                monotone: bool = True, on_loglik=None):
    """The stop-and-select loop of the JAX package's ``run_em_chunked``,
    over any update.

    ``scan_fn(state, n)`` runs n updates on the device with no host read
    and returns (the states after each update, a list of n, of which all
    but the last may be None; the logliks (n,) at each update's entering
    state, a tensor; per-update extras (n,) or None).  Each chunk of up to
    ``fused_chunk`` updates is read with ONE blocking read (``read_host``:
    the logliks, stacked with the extras if any).  The states of the
    current chunk and the two the stopping rule can still pick from the
    one before (its last two update counts) stay on the device, so a
    mid-chunk stop returns the state of exactly the update count the rule
    chose (converged: every update that ran; diverged: the state entering
    the pre-drop update); a chosen state given as None is replayed from
    the latest state kept before it, as the JAX package's
    ``run_em_chunked`` replays a chunk's prefix.  ``on_loglik(i, ll,
    entry_state, entry_count)`` runs for every loglik read, with the
    state and update count its chunk entered from.

    Returns (state, logliks (n,) np.float64, converged, update count,
    secs, extras) with ``secs[i]`` the host wall of update i's chunk,
    ending at its read, on the chunk's first update and 0.0 on the others,
    and ``extras`` the read extras of each chunk up to the stop (a list of
    arrays; empty without extras).
    """
    fused_chunk = max(1, int(fused_chunk))
    by_iter = {0: state0}      # update count -> state (None: replay)
    lls: list = []
    secs: list = []
    extras: list = []
    converged = stop = False
    target = it = 0
    while it < max_iters and not stop:
        t0 = time.perf_counter()
        n = min(fused_chunk, max_iters - it)
        entry = by_iter[it]
        states, chunk, extra = scan_fn(entry, n)
        if extra is None:
            chunk = read_host(chunk)                            # one read
        else:
            chunk, extra = read_host(torch.stack(
                [chunk, extra.to(chunk.dtype)]))                # one read
        wall = time.perf_counter() - t0
        base = max((i for i, q in by_iter.items()
                    if i < it and q is not None), default=it)
        by_iter = {i: q for i, q in by_iter.items()
                   if i >= min(it - 1, base)}
        by_iter.update({it + j + 1: q for j, q in enumerate(states)})
        for j, ll in enumerate(chunk):
            lls.append(float(ll))
            secs.append(wall if j == 0 else 0.0)
            if on_loglik is not None:
                on_loglik(it + j, float(ll), entry, it)
            state = em_progress(lls, tol, noise_floor, monotone=monotone)
            if state != "continue":
                converged = state == "converged"
                target = (len(lls) if converged
                          else max(len(lls) - 2, 0))
                stop = True
                break
        # Updates after a stop ran but are discarded: their extras do not
        # count.
        if extra is not None:
            extras.append(extra[:j + 1])
        it += n
    iters = target if stop else it
    state = by_iter[iters]
    if state is None:
        base = max(i for i, q in by_iter.items()
                   if i < iters and q is not None)
        state = scan_fn(by_iter[base], iters - base)[0][-1]
    return (state, np.asarray(lls), converged, iters, secs, extras)


def run_em_chunked(scan_fn, p0, max_iters: int, tol: float,
                   noise_floor: float, callback=None, fused_chunk: int = 8,
                   ss_tau=None, monitor=None, progress=None, pipeline=None,
                   monotone: bool = True):
    """The JAX package's shared chunked EM driver, its signature and stop
    semantics, as ``run_chunked`` over a JAX-shaped update.

    ``scan_fn(p, n) -> (p_new, logliks (n,), ss_deltas (n,) | None)`` runs
    n EM iterations with no host read (a 4th element, per-iteration
    metrics, is ignored).  Each chunk of up to ``fused_chunk`` iterations
    ends in ONE blocking read; a stop inside a chunk replays the chunk's
    prefix from the stored chunk-entry params (the previous chunk's when a
    divergence blames its last update), so the returned params embody
    exactly the update count the stopping rule chose.  ``callback(it, ll,
    p_entry)`` runs for every loglik with the chunk-entry params
    (``params_iter=`` too when the callback has ``wants_params_iter``);
    ``ss_tau`` feeds the freeze deltas up to the stop to
    ``warn_ss_delta``.  ``monitor`` (the guarded twin, ROADMAP Queue 1
    item 5), ``progress`` (item 3) and ``pipeline`` (item 4) raise when
    given.  Returns (p, logliks (n,) np.float64, converged, p_iters).
    """
    refuse_unported("run_em_chunked", ("monitor", monitor is not None, 5),
                    ("progress", progress is not None, 3),
                    ("pipeline", pipeline not in (None, 0, 1), 4))
    pass_piter = getattr(callback, "wants_params_iter", False)

    def scan(p, n):
        p_new, lls, deltas = scan_fn(p, n)[:3]
        return ([None] * (n - 1) + [p_new], torch.as_tensor(lls),
                None if deltas is None else torch.as_tensor(deltas))

    def on_loglik(i, ll, p_entry, entry_it):
        if pass_piter:
            callback(i, ll, p_entry, params_iter=entry_it)
        else:
            callback(i, ll, p_entry)

    with highest_precision():
        p, lls, converged, p_iters, _, deltas = run_chunked(
            scan, p0, max_iters, tol, noise_floor, fused_chunk, monotone,
            on_loglik=None if callback is None else on_loglik)
    if ss_tau is not None:
        warn_ss_delta(max((float(np.max(d)) for d in deltas), default=0.0),
                      ss_tau)
    return p, lls, converged, p_iters


def fit_em_chunked(Y, mask, p0: SSMParams, cfg: EMConfig, max_iters: int,
                   tol: float, fused_chunk: int = 8):
    """Chunked EM driver of ``fit`` on a panel, with the stop semantics of
    the JAX package's ``run_em_chunked`` (``run_chunked`` over
    ``em_fit_scan``, which keeps every update's params on the device, so
    a mid-chunk stop needs no replay).

    Each chunk runs up to ``fused_chunk`` iterations on the device and
    reads the chunk's logliks and ss freeze deltas with ONE blocking
    device->host read; a mid-chunk stop returns params that embody
    exactly the update count the stopping rule chose.

    Returns (params, logliks (n,) np.float64, converged, params_iters,
    secs, max_delta) with ``secs`` as ``run_chunked``'s and ``max_delta``
    the largest ss freeze delta of the iterations up to the stop (0.0 for
    the other engines; above 1e-4 it warns).
    """
    noise_floor = noise_floor_for(Y.dtype, Y.numel(),
                                  mult=cfg.noise_floor_mult)
    consts = _panel_consts(Y, mask is not None, cfg)
    with highest_precision():
        p, lls, converged, p_iters, secs, deltas = run_chunked(
            lambda q, n: em_fit_scan(Y, q, n, mask=mask, cfg=cfg,
                                     consts=consts),
            p0, max_iters, tol, noise_floor, fused_chunk,
            monotone=cfg_hypers(cfg) is None)
    max_delta = 0.0
    for d in deltas:
        max_delta = max(max_delta, float(np.max(d)))
    if cfg.filter == "ss":
        warn_ss_delta(max_delta, cfg.tau)
    return p, lls, converged, p_iters, secs, max_delta
