"""Stochastic-volatility DFM via a Rao-Blackwellized particle Kalman filter
(config S5, BASELINE.json:11).

The PyTorch twin of ``dfm_tpu.models.sv``.  Model:

    y_t = Lam f_t + eps_t,  eps ~ N(0, diag R);
    f_t = A f_{t-1} + eta_t,  eta_t ~ N(0, diag(exp(h_t)));
    h_t = h_{t-1} + sigma_h * xi_t          (factor-innovation log-vols).

Conditional on the log-vol path the model is linear-Gaussian, so each of
M particles carries an exact Kalman state (x, P) beside its h, and its
weight increment is the Kalman innovation density.  Two kernels carry the
family (``csrc/sv_rbpf.cu`` to k = 16 and 1,024 particles; past either,
to k = 128 and any particle count, their generic twins in
``csrc/sv_gen.cu``, ``kernels.route_sv``):

  K10-fwd  ``rbpf_scan``: the whole T-step RBPF scan (per-particle
           info-form update, residual weights in the ``"residual"`` or
           ``"expanded"`` quad form, systematic resampling when
           ESS < ess_frac * M, decided on the device), enqueued by one C
           call a pass;
  K10-ffbs ``ffbs``: forward-filtering backward-sampling of S smoothed
           log-vol trajectories by the Gumbel-max trick, a block a draw.

Each wrapper runs its plain-torch twin (``*_plain``) for CPU tensors and
the kernel for CUDA tensors; nothing falls back.  The particle-independent
loglik constant (and the expanded form's -c2_t/2) is added in float64 and
the per-step increments are read back in one packed read a pass.

Random draws.  torch cannot reproduce ``jax.random``'s bits, so the port
takes its noise as explicit draws: ``SVDraws`` for the filter (h_0 noise,
the log-vol walk's normals, the resampling uniforms) and ``FFBSDraws``
for the backward sampler (Gumbels, ``-log(-log U)`` as
``jax.random.gumbel`` computes them).  ``sv_filter``, ``sv_smooth_h`` and
``sv_fit`` make them up front on the device from a ``torch.Generator``
(seed 0 when none is given), or take them as ``draws=``; the tests fill
them from the JAX package's key schedule, so both packages run on the
same numbers.

Estimation (``sv_fit``) is particle EM: an EM pre-fit of the
homoskedastic DFM through the port's own ``fit``, then E-steps of the
RBPF and FFBS, and the closed-form M-step for sigma_h and the h_0 center
on the device (the log-domain over-relaxation of the JAX package).  An
E-step reads the host once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..estim import fused as _fused
from ..ops.linalg import (UNROLL_K_MAX, chol_small, chol_solve,
                          chol_solve_unrolled, chol_unrolled, matmul_vpu,
                          matvec_vpu, psd_cholesky, sym)
from ..ops.precision import highest_precision
from ..robust.health import health_from_trace
from ..ssm.params import SSMParams

__all__ = ["SVSpec", "SVResult", "SVFit", "SVDraws", "FFBSDraws",
           "sv_draws", "ffbs_draws", "estep_draws", "systematic_indices",
           "rbpf_scan", "rbpf_scan_gen", "rbpf_scan_plain", "ffbs",
           "ffbs_gen", "ffbs_plain",
           "sv_filter", "sv_smooth_h", "sv_fit", "sv_forecast",
           "e_step_device", "m_step", "SIGMA_FLOOR"]

_LOG2PI = 1.8378770664093453
SIGMA_FLOOR = 1e-4   # below this the model is effectively homoskedastic


@dataclasses.dataclass(frozen=True)
class SVSpec:
    n_factors: int
    n_particles: int = 512
    ess_frac: float = 0.5         # resample when ESS < ess_frac * M
    sigma_h: float = 0.1          # initial log-vol random-walk scale
    h0_scale: float = 0.1         # prior std of h_0 around its center
    quad_form: str = "residual"   # "residual" (exact) | "expanded" (fast)
    n_smooth_draws: int = 64      # FFBS trajectories for smoothing / EM


class SVResult(NamedTuple):
    loglik: np.ndarray            # scalar marginal loglik (f64 assembly)
    f_mean: torch.Tensor          # (T, k) weighted filtered factor means
    h_mean: torch.Tensor          # (T, k) weighted filtered log-vols
    ess: torch.Tensor             # (T,) effective sample size per step
    n_resamples: torch.Tensor     # scalar (int32)
    h_particles: Optional[torch.Tensor]  # (T, M, k) filtering h-cloud
    #                                    # (post-resample); None if
    #                                    # store_paths=False
    logw: Optional[torch.Tensor]         # (T, M) matching normalized
    #                                    # log-weights
    lls: np.ndarray               # (T,) per-step loglik increments (f64)


class SVDraws(NamedTuple):
    """The filter's noise: ``h0`` (M, k) standard normals of h_0 around
    its center, ``xi`` (T, M, k) standard normals of the log-vol walk at
    each step, ``u`` (T,) the systematic-resampling uniform of each step
    (drawn whether or not the step resamples)."""

    h0: torch.Tensor
    xi: torch.Tensor
    u: torch.Tensor


class FFBSDraws(NamedTuple):
    """The backward sampler's Gumbels: ``g_last`` (S, M) for the draw at
    step T-1, ``g`` (T-1, S, M) with row t for step t."""

    g_last: torch.Tensor
    g: torch.Tensor


class _Pass(NamedTuple):
    """One filter pass on the device, before its host read."""

    lls: torch.Tensor             # (T,) f64 per-step increments
    f_mean: torch.Tensor
    h_mean: torch.Tensor
    ess: torch.Tensor
    n_resamples: torch.Tensor
    h_particles: Optional[torch.Tensor]
    logw: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def _generator(generator, device) -> torch.Generator:
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


def sv_draws(T: int, M: int, k: int, dtype, device,
             generator: Optional[torch.Generator] = None) -> SVDraws:
    """A filter pass's ``SVDraws``, made on ``device`` from ``generator``
    (the generator's device must be ``device``)."""
    g = _generator(generator, device)
    kw = dict(generator=g, dtype=dtype, device=device)
    return SVDraws(torch.randn((M, k), **kw), torch.randn((T, M, k), **kw),
                   torch.rand((T,), **kw))


def _gumbel(shape, generator, dtype, device) -> torch.Tensor:
    U = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    U = torch.clamp(U, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(U))


def ffbs_draws(T: int, S: int, M: int, dtype, device,
               generator: Optional[torch.Generator] = None) -> FFBSDraws:
    """A backward pass's ``FFBSDraws`` from ``generator``."""
    g = _generator(generator, device)
    return FFBSDraws(_gumbel((S, M), g, dtype, device),
                     _gumbel((max(T - 1, 0), S, M), g, dtype, device))


def estep_draws(T: int, spec: SVSpec, smooth: bool, dtype, device,
                generator: torch.Generator):
    """One E-step's draws: (``SVDraws``, ``FFBSDraws`` or None)."""
    M, k = spec.n_particles, spec.n_factors
    fd = sv_draws(T, M, k, dtype, device, generator)
    bd = (ffbs_draws(T, spec.n_smooth_draws, M, dtype, device, generator)
          if smooth else None)
    return fd, bd


# ---------------------------------------------------------------------------
# K10-fwd: the RBPF scan
# ---------------------------------------------------------------------------

def systematic_indices(logW: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Systematic resampling indices (M,) from normalized ``logW`` and one
    uniform ``u``: the first i with cum_i >= (m + u) / M (searchsorted
    side 'left') on the cumsum normalized by its last entry, clipped to
    [0, M-1]."""
    M = logW.shape[0]
    cum = torch.cumsum(torch.exp(logW), 0)
    cum = cum / cum[-1]
    pos = (torch.arange(M, dtype=cum.dtype, device=cum.device) + u) / M
    return torch.clamp(torch.searchsorted(cum, pos), 0, M - 1)


def _quad_form(P, u):
    """u' P u per particle, (M,)."""
    return (matvec_vpu(P, u) * u).sum(-1)


def rbpf_scan_plain(Y, Lam, R, C, B, A, mu0, P0, h_center, sigma_h,
                    h0_scale: float, draws: SVDraws, ess_frac: float,
                    residual: bool, store_paths: bool):
    """Plain-torch twin of K10-fwd, step for step the JAX ``_rbpf_scan``.

    ``Y`` (T, N), ``Lam`` (N, k), ``R`` (N,), ``C`` = Lam'R^{-1}Lam (k, k),
    ``B`` = Y R^{-1} Lam (T, k) (read only in the expanded form; may be
    None in the residual one), ``h_center`` and ``sigma_h`` (k,).  Returns
    (ll_rel (T,), f_mean (T, k), h_mean (T, k), ess (T,), n_resamples
    (int32 scalar), h_hist (T, M, k) or None, logw_hist (T, M) or None).
    The resampling branch is a ``torch.where`` on the device."""
    T = Y.shape[0]
    M, k = draws.h0.shape
    dt, dev = Y.dtype, Y.device
    I_k = torch.eye(k, dtype=dt, device=dev)
    Rinv = 1.0 / R
    small_k = k <= UNROLL_K_MAX
    logW0 = -math.log(float(M))
    thr = ess_frac * M
    h = h_center[None, :] + h0_scale * draws.h0
    x = mu0.expand(M, k)
    P = P0.expand(M, k, k)
    logW = torch.full((M,), logW0, dtype=dt, device=dev)
    n_rs = torch.zeros((), dtype=torch.int32, device=dev)
    ll_rel, f_mean, h_mean, ess_o, h_hist, logw_hist = [], [], [], [], [], []
    for t in range(T):
        h = h + sigma_h[None, :] * draws.xi[t]
        x_p = matvec_vpu(A[None], x)                            # x A'
        P_p = matmul_vpu(matmul_vpu(A[None], P), A.T[None])     # A P A'
        P_p = P_p + torch.exp(h)[:, :, None] * I_k[None]
        if small_k:
            Lp = chol_unrolled(sym(P_p), jitter=1e-6)
        else:
            Lp = psd_cholesky(P_p, jitter=1e-6)
        LpT = Lp.transpose(-1, -2)
        Gm = I_k[None] + matmul_vpu(LpT, matmul_vpu(C[None], Lp))
        if small_k:
            Lg = chol_unrolled(Gm)
            Xs = chol_solve_unrolled(Lg, LpT)
        else:
            # jnp.linalg.cholesky symmetrizes its input.
            Lg = chol_small(sym(Gm))
            Xs = chol_solve(Lg, LpT)
        P_f = sym(matmul_vpu(Lp, Xs))
        if residual:
            V = Y[t][None, :] - x_p @ Lam.T                     # (M, N)
            VR = V * Rinv[None, :]
            c2 = (V * VR).sum(-1)                               # v'R^-1 v
            u = VR @ Lam                                        # Lam'R^-1 v
            quad = c2 - _quad_form(P_f, u)
        else:
            b_t = B[t][None, :]
            u = b_t - matvec_vpu(C[None], x_p)
            quad = (-2.0 * (x_p * b_t).sum(-1)
                    + (matvec_vpu(C[None], x_p) * x_p).sum(-1)
                    - _quad_form(P_f, u))
        x_f = x_p + matvec_vpu(P_f, u)
        logdetG = 2.0 * torch.log(torch.diagonal(Lg, dim1=-2,
                                                 dim2=-1)).sum(-1)
        lw = -0.5 * (logdetG + quad)
        tot = logW + lw
        mx = tot.max()
        ll = mx + torch.log(torch.exp(tot - mx).sum())
        logW = tot - ll                                         # normalized
        ess = 1.0 / torch.exp(2.0 * logW).sum()
        do = ess < thr
        idx = systematic_indices(logW, draws.u[t])
        x_f = torch.where(do, x_f[idx], x_f)
        P_f = torch.where(do, P_f[idx], P_f)
        h = torch.where(do, h[idx], h)
        logW = torch.where(do, torch.full_like(logW, logW0), logW)
        n_rs = n_rs + do.to(torch.int32)
        W = torch.exp(logW)
        ll_rel.append(ll)
        f_mean.append(W @ x_f)
        h_mean.append(W @ h)
        ess_o.append(ess)
        if store_paths:
            h_hist.append(h)
            logw_hist.append(logW)
        x, P = x_f, P_f
    return (torch.stack(ll_rel), torch.stack(f_mean), torch.stack(h_mean),
            torch.stack(ess_o), n_rs,
            torch.stack(h_hist) if store_paths else None,
            torch.stack(logw_hist) if store_paths else None)


def _route(name, k, M, specs, dt, dev, generic: bool) -> str:
    """The kernel ``kernels.route_sv`` gives ``name`` at (k, M), once the
    tensors are checked: K10's own to k = 16 and M = 1,024, the generic one
    past either (to k = 128, any M); the generic one at every (k, M) it
    takes if ``generic``."""
    got = kernels.route_sv(name, k, M)
    if generic:
        got = kernels.GEN[name]
    for arg, x, shape in specs:
        kernels.check_tensor(arg, x, shape, dt, dev)
    return got


def rbpf_scan(Y, Lam, R, C, B, A, mu0, P0, h_center, sigma_h,
              h0_scale: float, draws: SVDraws, ess_frac: float,
              residual: bool, store_paths: bool):
    """The RBPF scan: kernel K10-fwd (``csrc/sv_rbpf.cu``; past k = 16 or
    1,024 particles K10-fwd-gen, ``csrc/sv_gen.cu``) for CUDA tensors, one
    C call enqueuing the whole T loop (one ``LAUNCHES`` count); the plain
    twin for CPU tensors.  Arguments and returns as ``rbpf_scan_plain``."""
    return _rbpf_scan(Y, Lam, R, C, B, A, mu0, P0, h_center, sigma_h,
                      h0_scale, draws, ess_frac, residual, store_paths,
                      False)


def rbpf_scan_gen(Y, Lam, R, C, B, A, mu0, P0, h_center, sigma_h,
                  h0_scale: float, draws: SVDraws, ess_frac: float,
                  residual: bool, store_paths: bool):
    """``rbpf_scan`` through K10-fwd-gen at every k <= 128 and M >= 1 (what
    ``rbpf_scan`` launches past k = 16 or 1,024 particles; this entry holds
    it below both too); the plain twin for CPU tensors."""
    return _rbpf_scan(Y, Lam, R, C, B, A, mu0, P0, h_center, sigma_h,
                      h0_scale, draws, ess_frac, residual, store_paths,
                      True)


def _rbpf_scan(Y, Lam, R, C, B, A, mu0, P0, h_center, sigma_h, h0_scale,
               draws, ess_frac, residual, store_paths, generic: bool):
    if Y.device.type == "cpu":
        return rbpf_scan_plain(Y, Lam, R, C, B, A, mu0, P0, h_center,
                               sigma_h, h0_scale, draws, ess_frac, residual,
                               store_paths)
    T, N = Y.shape
    M, k = draws.h0.shape
    dt, dev = Y.dtype, Y.device
    specs = [("Y", Y, (T, N)), ("Lam", Lam, (N, k)), ("R", R, (N,)),
             ("C", C, (k, k)), ("A", A, (k, k)), ("mu0", mu0, (k,)),
             ("P0", P0, (k, k)), ("h_center", h_center, (k,)),
             ("sigma_h", sigma_h, (k,)), ("draws.h0", draws.h0, (M, k)),
             ("draws.xi", draws.xi, (T, M, k)), ("draws.u", draws.u, (T,))]
    if not residual:
        specs.append(("B", B, (T, k)))
    name = _route("sv_rbpf", k, M, specs, dt, dev, generic)
    e = dict(dtype=dt, device=dev)
    ll_rel = torch.empty((T,), **e)
    f_mean = torch.empty((T, k), **e)
    h_mean = torch.empty((T, k), **e)
    ess = torch.empty((T,), **e)
    n_rs = torch.empty((), dtype=torch.int32, device=dev)
    h_hist = torch.empty((T, M, k), **e) if store_paths else None
    logw_hist = torch.empty((T, M), **e) if store_paths else None
    head = (Y, Lam, R, C, None if residual else B, A, mu0, P0, h_center,
            sigma_h, draws.h0, draws.xi, draws.u, ll_rel, f_mean, h_mean,
            ess, n_rs, h_hist, logw_hist)
    if name == "sv_rbpf":
        # Scratch: the particle state between steps and its gather copy
        # (x_p, P_f, log|G|, h, logW, then x_f and h to gather from), and
        # the residual stage's per-tile partials (c2 in f64, u),
        # kernels.SV_TILE series a tile.
        state = torch.empty((M * (4 * k + k * k + 2),), **e)
        tiles = -(-N // kernels.SV_TILE) if residual else 0
        c2p = torch.empty((tiles, M), dtype=torch.float64, device=dev)
        up = torch.empty((tiles, k, M), **e)
        kernels.launch(name, dt, *head, state, c2p, up, T, N, k, M,
                       int(residual), float(h0_scale), float(ess_frac))
    else:
        # Scratch (csrc/sv_gen.cu, SvgState): x_p, x_f, two h buffers,
        # log|G|, logW, tot and the normalized cumsum; P_f double buffered;
        # the resampling flag and indices; the residual stage's partials a
        # chunk of ``nsc`` series (c2 in f64, u); the prediction's global
        # workspace where a particle's three k x k matrices pass shared
        # memory.  The sizes come from the source's rules.
        sms = kernels.gen_ctas(dev, 1 << 30)
        nsc = (kernels.query("sv_rbpf_gen_series", dt, N, M, sms)
               if residual else 0)
        chunks = -(-N // nsc) if residual else 0
        slots = kernels.query("sv_rbpf_gen_slots", dt, k, M, sms)
        state = torch.empty((M * (4 * k + 4),), **e)
        Pf = torch.empty((2, M, k, k), **e)
        istate = torch.empty((M + 1,), dtype=torch.int32, device=dev)
        c2p = torch.empty((chunks, M), dtype=torch.float64, device=dev)
        up = torch.empty((chunks, M, k), **e)
        work = torch.empty((slots, 3, k, k | 1), **e) if slots else None
        kernels.launch(name, dt, *head, state, Pf, istate, c2p, up, work, T,
                       N, k, M, int(residual), nsc, slots, float(h0_scale),
                       float(ess_frac))
    return ll_rel, f_mean, h_mean, ess, n_rs, h_hist, logw_hist


# ---------------------------------------------------------------------------
# K10-ffbs: backward sampling
# ---------------------------------------------------------------------------

def ffbs_plain(h_hist, logw_hist, sigma_h, draws: FFBSDraws):
    """Plain-torch twin of K10-ffbs (the JAX ``_ffbs_impl``): S smoothed
    log-vol trajectories (T, S, k) by Gumbel-max backward sampling;
    ``argmax`` takes the lowest index on ties, as ``jnp.argmax`` does."""
    T = h_hist.shape[0]
    s2 = torch.clamp(sigma_h ** 2, min=1e-20)
    idx = torch.argmax(logw_hist[-1][None, :] + draws.g_last, dim=1)
    h_next = h_hist[-1][idx]                                   # (S, k)
    out = [None] * T
    out[T - 1] = h_next
    for t in range(T - 2, -1, -1):
        d2 = ((h_next[:, None, :] - h_hist[t][None, :, :]) ** 2
              / s2[None, None, :]).sum(-1)                     # (S, M)
        logbw = logw_hist[t][None, :] - 0.5 * d2
        idx = torch.argmax(logbw + draws.g[t], dim=1)
        h_next = h_hist[t][idx]
        out[t] = h_next
    return torch.stack(out)


def ffbs(h_hist, logw_hist, sigma_h, draws: FFBSDraws):
    """Backward sampling: kernel K10-ffbs (``csrc/sv_rbpf.cu``, a block a
    draw; past k = 16 or 1,024 particles K10-ffbs-gen, ``csrc/sv_gen.cu``,
    a block of four draws) for CUDA tensors, the plain twin for CPU
    tensors.  Returns (T, S, k)."""
    return _ffbs(h_hist, logw_hist, sigma_h, draws, False)


def ffbs_gen(h_hist, logw_hist, sigma_h, draws: FFBSDraws):
    """``ffbs`` through K10-ffbs-gen at every k <= 128 and M >= 1 (what
    ``ffbs`` launches past k = 16 or 1,024 particles; this entry holds it
    below both too); the plain twin for CPU tensors."""
    return _ffbs(h_hist, logw_hist, sigma_h, draws, True)


def _ffbs(h_hist, logw_hist, sigma_h, draws, generic: bool):
    if h_hist.device.type == "cpu":
        return ffbs_plain(h_hist, logw_hist, sigma_h, draws)
    T, M, k = h_hist.shape
    S = draws.g_last.shape[0]
    dt, dev = h_hist.dtype, h_hist.device
    name = _route("sv_ffbs", k, M,
                  [("h_hist", h_hist, (T, M, k)),
                   ("logw_hist", logw_hist, (T, M)),
                   ("sigma_h", sigma_h, (k,)),
                   ("draws.g_last", draws.g_last, (S, M)),
                   ("draws.g", draws.g, (T - 1, S, M))], dt, dev,
                  generic)
    out = torch.empty((T, S, k), dtype=dt, device=dev)
    kernels.launch(name, dt, h_hist, logw_hist, sigma_h, draws.g_last,
                   draws.g, out, T, M, k, S)
    return out


# ---------------------------------------------------------------------------
# Filter, smoother, forecast
# ---------------------------------------------------------------------------

def _as_sigma_vec(sigma_h, k, dtype, device) -> torch.Tensor:
    s = torch.as_tensor(sigma_h, dtype=dtype, device=device)
    return (s.expand(k) if s.ndim == 0 else s).contiguous()


def _filter_pass(Y, p: SSMParams, spec: SVSpec, h_center, sigma_h,
                 draws: SVDraws, store_paths: bool) -> _Pass:
    """One RBPF pass on the device (``_sv_filter_impl`` with the f64
    assembly of ``_host_lls`` kept on the device): C = Lam'R^{-1}Lam and,
    in the expanded form, B = Y R^{-1}Lam stay ``torch.matmul``, as the
    JAX package computes them outside its scan."""
    residual = spec.quad_form == "residual"
    Rinv = 1.0 / p.R
    G0 = p.Lam * Rinv[:, None]                        # R^{-1} Lam, (N, k)
    C = (p.Lam.T @ G0).contiguous()
    B = None if residual else (Y @ G0).contiguous()
    ll_rel, f_mean, h_mean, ess, n_rs, h_hist, logw_hist = rbpf_scan(
        Y, p.Lam, p.R, C, B, p.A, p.mu0, p.P0, h_center, sigma_h,
        float(spec.h0_scale), draws, spec.ess_frac, residual, store_paths)
    # The particle-independent constant -(N log 2pi + log|R|)/2 (and the
    # expanded quad's -c2_t/2) in float64, so rounding does not grow with T.
    R64 = p.R.to(torch.float64)
    lls = ll_rel.to(torch.float64) - 0.5 * (
        Y.shape[1] * _LOG2PI + torch.log(R64).sum())
    if not residual:
        Y64 = Y.to(torch.float64)
        lls = lls - 0.5 * torch.einsum("tn,n,tn->t", Y64, 1.0 / R64, Y64)
    return _Pass(lls, f_mean, h_mean, ess, n_rs, h_hist, logw_hist)


def _result(fp: _Pass) -> SVResult:
    """The pass's one blocking read: the f64 per-step increments."""
    lls = _fused.read_packed({"lls": fp.lls})["lls"]
    return SVResult(loglik=np.sum(lls), f_mean=fp.f_mean, h_mean=fp.h_mean,
                    ess=fp.ess, n_resamples=fp.n_resamples,
                    h_particles=fp.h_particles, logw=fp.logw, lls=lls)


def _prep(Y, p: SSMParams, spec: SVSpec, h_center, sigma_h):
    dt, dev = Y.dtype, Y.device
    p = SSMParams(*(x.to(device=dev, dtype=dt).contiguous() for x in p))
    if h_center is None:
        h_center = torch.log(torch.clamp(torch.diagonal(p.Q), min=1e-8))
    h_center = torch.as_tensor(h_center, dtype=dt, device=dev).contiguous()
    sig = _as_sigma_vec(spec.sigma_h if sigma_h is None else sigma_h,
                        spec.n_factors, dt, dev)
    return p, h_center, sig


def _refuse_key(fn: str, key) -> None:
    """A ``jax.random`` key cannot seed the port's draws: torch cannot
    reproduce ``jax.random``'s numbers, so the port takes a
    ``torch.Generator`` or explicit draws instead."""
    if key is not None:
        raise NotImplementedError(
            f"{fn}(key=): torch cannot reproduce jax.random, so the port "
            "takes no JAX key; pass generator= (a torch.Generator) or "
            "draws= (the explicit draws, e.g. replayed from a JAX key "
            "schedule) instead")


def sv_filter(Y, p: SSMParams, spec: SVSpec,
              generator: Optional[torch.Generator] = None,
              h_center=None, sigma_h=None, store_paths: bool = True,
              draws: Optional[SVDraws] = None, key=None) -> SVResult:
    """Rao-Blackwellized particle Kalman filter for the SV-DFM.

    ``Y`` (T, N) tensor on the device the pass runs on (its dtype is the
    compute dtype); ``p`` supplies (Lam, A, R, mu0, P0) as tensors; the
    factor-innovation covariance is NOT p.Q but diag(exp(h_t)) with h_0 ~
    N(h_center, h0_scale^2 I); ``h_center`` defaults to log(diag(Q)).
    ``sigma_h`` (scalar or (k,)) overrides ``spec.sigma_h``.
    ``store_paths=False`` skips the (T, M, k) particle history (needed
    only for FFBS), the filter-timing mode.  ``draws``: the pass's
    ``SVDraws``, else drawn from ``generator``; a JAX ``key`` raises
    (``_refuse_key``).  Runs in true f32 matrix products (no TF32) and
    reads the host once."""
    _refuse_key("sv_filter", key)
    with highest_precision():
        p, h_center, sig = _prep(Y, p, spec, h_center, sigma_h)
        if draws is None:
            draws = sv_draws(Y.shape[0], spec.n_particles, spec.n_factors,
                             Y.dtype, Y.device, generator)
        return _result(_filter_pass(Y, p, spec, h_center, sig, draws,
                                    store_paths))


def sv_smooth_h(res: SVResult, sigma_h,
                generator: Optional[torch.Generator] = None,
                n_draws: int = 64,
                draws: Optional[FFBSDraws] = None,
                key=None) -> torch.Tensor:
    """FFBS: ``n_draws`` smoothed log-vol trajectories, shape (T, S, k).

    Backward weights combine the stored filtering weights with the
    random-walk transition density N(h_{t+1}; h_t, diag(sigma_h^2));
    sampling is by the Gumbel-max trick on ``draws`` (else drawn from
    ``generator``); a JAX ``key`` raises (``_refuse_key``)."""
    _refuse_key("sv_smooth_h", key)
    if res.h_particles is None:
        raise ValueError(
            "sv_smooth_h needs the filtering particle history; run "
            "sv_filter with store_paths=True")
    T, M, k = res.h_particles.shape
    dt, dev = res.h_particles.dtype, res.h_particles.device
    if draws is None:
        draws = ffbs_draws(T, n_draws, M, dt, dev, generator)
    return ffbs(res.h_particles, res.logw, _as_sigma_vec(sigma_h, k, dt, dev),
                draws)


@dataclasses.dataclass
class SVFit:
    params: object               # cpu_ref.SSMParams from the EM pre-fit
    result: SVResult             # filter output at the final SV parameters
    vol_paths: np.ndarray        # (T, k) smoothed vol proxy exp(h_smooth/2)
    loglik: float
    sigma_h: np.ndarray = None   # (k,) estimated vol-walk scales
    h_center: np.ndarray = None  # (k,) estimated h_0 prior center
    h_smooth: np.ndarray = None  # (T, k) FFBS-smoothed log-vol means
    logliks: np.ndarray = None   # per-SV-iteration marginal logliks
    standardizer: object = None  # utils.data.Standardizer from the pre-fit
    health: object = None        # robust.FitHealth trace record


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def sv_forecast(fit: SVFit, horizon: int):
    """h-step forecast of the SV-DFM.  Conditional means are the
    homoskedastic iteration f_{T+j} = A^j f_T from the filtered particle
    mean, y = f Lam' de-standardized; the third return is the
    factor-innovation vol forecast E[exp(h_{T+j}/2)] = exp(h_T/2 + j
    sigma_h^2 / 8).  Returns (y_fore (h, N), f_fore (h, k), vol_fore (h,
    k))."""
    A = np.asarray(fit.params.A, np.float64)
    Lam = np.asarray(fit.params.Lam, np.float64)
    k = A.shape[0]
    x = _np64(fit.result.f_mean[-1])
    h_T = np.asarray(fit.h_smooth[-1], np.float64)
    s2 = np.asarray(fit.sigma_h, np.float64) ** 2 \
        if fit.sigma_h is not None else np.zeros(k)
    f = np.zeros((horizon, k))
    vol = np.zeros((horizon, k))
    for j in range(horizon):
        x = A @ x
        f[j] = x
        vol[j] = np.exp(0.5 * h_T + (j + 1) * s2 / 8.0)
    y = f @ Lam.T
    if fit.standardizer is not None:
        y = fit.standardizer.inverse(y)
    return y, f, vol


# ---------------------------------------------------------------------------
# Particle EM
# ---------------------------------------------------------------------------

def e_step_device(Y, p: SSMParams, spec: SVSpec, sigma, h_center, draws,
                  smooth: bool):
    """One E-step's device work, with no host read: the RBPF pass (K10-fwd
    and the f64 increments) and, when ``smooth``, FFBS (K10-ffbs).
    ``draws`` = (``SVDraws``, ``FFBSDraws`` or None).  Returns (the pass,
    H (T, S, k) or None)."""
    fd, bd = draws
    fp = _filter_pass(Y, p, spec, h_center, sigma, fd, store_paths=smooth)
    H = ffbs(fp.h_particles, fp.logw, sigma, bd) if smooth else None
    return fp, H


def m_step(H, sigma, prev_step, sv_accel: float):
    """The closed-form M-step on the device: sigma_EM from the smoothed
    increments, the over-relaxed log-domain step (plain EM per factor
    where the step flips sign), the floor; h_0's center from the draws at
    t = 0.  Returns (sigma, h_center, step)."""
    dH = torch.diff(H, dim=0)
    sigma_em = torch.sqrt(torch.mean(dH ** 2, dim=(0, 1)))
    step = (torch.log(torch.clamp(sigma_em, min=SIGMA_FLOOR))
            - torch.log(sigma))
    accel = (torch.where(step * prev_step < 0, torch.ones_like(step),
                         torch.full_like(step, sv_accel))
             if prev_step is not None else sv_accel)
    sigma = torch.clamp(sigma * torch.exp(accel * step), min=SIGMA_FLOOR)
    return sigma, torch.mean(H[0], dim=0), step


def sv_fit(Y: np.ndarray, spec: SVSpec, em_iters: int = 20,
           generator: Optional[torch.Generator] = None, backend=None,
           standardize: bool = True, sv_iters: int = 10,
           sv_accel: float = 3.0, estimate_sv: bool = True,
           mesh=None, draws: Optional[Sequence] = None,
           key=None) -> SVFit:
    """SV-DFM estimation (BASELINE.json:11):

    1. EM pre-fit of the homoskedastic DFM (Lam, A, Q, R) through the
       port's ``fit`` on ``backend`` (a ``TorchBackend``; None for the
       default, CUDA), whose dtype and device the particle EM takes.
    2. Particle EM for the SV law: RBPF E-step + FFBS h-trajectory draws,
       closed-form M-step for the per-factor vol-walk scale sigma_h and
       the h_0 center, ``sv_iters`` rounds, then one final E-step at the
       returned parameters.  ``estimate_sv=False`` (or ``sv_iters <= 0``)
       filters once at ``spec.sigma_h``, with no FFBS.

    ``sv_accel`` over-relaxes the M-step in the log domain (sigma <- sigma
    (sigma_EM / sigma)^accel).  ``draws``: one (``SVDraws``, ``FFBSDraws``
    or None) per E-step in order, else each E-step's draws come from
    ``generator`` (``estep_draws``).  Each E-step reads the host once (its
    per-step loglik increments), the result once more.  ``mesh`` is not
    ported; a JAX ``key`` raises (``_refuse_key``)."""
    _refuse_key("sv_fit", key)
    if mesh is not None:
        raise NotImplementedError(
            "sv_fit(mesh=) is not ported to dfm_tpu_torch yet: the "
            "series-sharded RBPF is ROADMAP Queue 1 item 12")
    from ..api import DynamicFactorModel, TorchBackend, fit as _fit
    b = TorchBackend() if backend is None else backend
    model = DynamicFactorModel(n_factors=spec.n_factors,
                               standardize=standardize)
    pre = _fit(model, Y, backend=b, max_iters=em_iters)
    Yz = np.asarray(Y, np.float64)
    if pre.standardizer is not None:
        Yz = pre.standardizer.transform(Yz)
    if sv_iters <= 0:
        estimate_sv = False
    n_e = sv_iters + 1 if estimate_sv else 1
    if draws is not None and len(draws) != n_e:
        raise ValueError(f"sv_fit runs {n_e} E-steps; got draws for "
                         f"{len(draws)}")
    dt, dev = b.dtype, b.device
    with highest_precision():
        pj = SSMParams.from_numpy(pre.params, dtype=dt, device=dev)
        Yj = torch.as_tensor(Yz, dtype=dt, device=dev).contiguous()
        gen = _generator(generator, dev)
        sigma = torch.full((spec.n_factors,), spec.sigma_h, dtype=dt,
                           device=dev)
        h_center = torch.log(torch.clamp(torch.diagonal(pj.Q), min=1e-8))
        if estimate_sv:
            sigma = torch.clamp(sigma, min=SIGMA_FLOOR)  # log-step: sigma > 0
        logliks, prev_step, H = [], None, None
        for i in range(n_e):
            dr = (draws[i] if draws is not None else
                  estep_draws(Yj.shape[0], spec, estimate_sv, dt, dev, gen))
            fp, H = e_step_device(Yj, pj, spec, sigma, h_center, dr,
                                  smooth=estimate_sv)
            res = _result(fp)
            logliks.append(float(res.loglik))
            if estimate_sv and i < n_e - 1:
                sigma, h_center, prev_step = m_step(H, sigma, prev_step,
                                                     sv_accel)
        # Without estimation no FFBS pass runs; the smoothed proxy is then
        # the filtered h mean.
        out = _fused.read_packed({
            "sigma": sigma, "h_center": h_center,
            "h_smooth": torch.mean(H, dim=1) if H is not None
            else res.h_mean})
    h_smooth = out["h_smooth"]
    return SVFit(params=pre.params, result=res,
                 vol_paths=np.exp(0.5 * h_smooth), loglik=logliks[-1],
                 sigma_h=out["sigma"], h_center=out["h_center"],
                 h_smooth=h_smooth, logliks=np.asarray(logliks),
                 standardizer=pre.standardizer,
                 # MC particle logliks are noisy by construction: record
                 # only non-finite values, never monotonicity "violations".
                 health=health_from_trace(logliks, noise_floor=np.inf))
