"""Capacity-buffer maintenance (kernels K13 and K13b) and the fleet core.

The PyTorch twin of ``dfm_tpu.serve.batched``.

K13, the single-session form: ``ring_evict_append`` retires the oldest
``n_evict`` rows of a capacity-padded (T_cap, N) panel and its mask,
shifts the live window back to the buffer origin, re-zeroes the tail, and
writes the update's ``r_max`` padded rows at the new live end, dropping
rows past capacity (``ring_evict`` together with the append that follows
it in ``dfm_tpu.serve.session._session_core``).  ``n_evict`` and
``t_cur`` are host integers: a session tracks both.

K13b, the fleet's form: ``batched_ring_evict_append`` does the same for B
lanes of (B, T_cap, N) buffers in one launch, with each lane's counts in
(B,) int32 tensors on the device (``batched_ring_evict`` followed by
``estim.batched.batched_ragged_append``).  On CUDA tensors both launch
``csrc/ring_append.cu``; on CPU tensors they run their plain twins, the
JAX routines' algebra (roll, select, scatter with drop), which equal the
kernels bit for bit.

The fleet core (``_fleet_core``) is one tick of a fleet bucket: K13b, a
static ``max_iters`` warm EM with per-lane freezes, roll-backs and stops
(``_fleet_em_scan``), the reporting smooth, nowcasts, bands, forecasts and
diffusion-index forecasts for every lane, with no host read.  Engines:
``info`` runs the masked batched twins of ``estim.batched`` (K2b-m,
K4b-fwd over a per-step C, K1b-m, K4b-bwd, K3b-m, K6b); ``lowrank`` runs
K2b-m, K9-basis, K9-fwd, K1b-m (its quad_R) and K9-bwd once each over the
whole bucket; ``pit_qr`` runs the lone masked pit_qr filter and smoother
once per lane, which is exact because lanes are independent.  The sharded
tick (``fleet_impl_sharded``) raises until it is ported (ROADMAP Queue 1
item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import kernels
from ..estim.batched import (_batched_obs_stats_masked, _batched_quad_masked,
                             _batched_rts, _bmask, _bT,
                             batched_filter_masked, batched_m_step_masked,
                             batched_ragged_append)
from ..estim.fused import _di_forecast_batched
from ..ops.linalg import matmul_vpu, matvec_vpu
from ..ops.precision import accum_dtype
from ..ssm.info_filter import ObsStats
from ..ssm.lowrank_filter import (lowrank_loglik_from_terms, lowrank_scan,
                                  lowrank_smoother_scan, policy_basis,
                                  resolve_rank)
from ..ssm.params import SSMParams

__all__ = ["ring_evict_append", "ring_evict_append_plain", "ring_evict",
           "batched_ring_evict", "batched_ring_evict_append",
           "batched_ring_evict_append_plain", "FleetOptions",
           "fleet_impl_sharded", "RUNNING", "CONVERGED", "DIVERGED"]

RUNNING, CONVERGED, DIVERGED = 0, 1, 2


def _check_counts(T_cap: int, r_max: int, n_evict: int, t_cur: int) -> None:
    if not 0 <= n_evict <= t_cur <= T_cap:
        raise ValueError(f"ring_evict_append needs 0 <= n_evict <= t_cur <= "
                         f"T_cap; got n_evict={n_evict}, t_cur={t_cur}, "
                         f"T_cap={T_cap}")
    if r_max < 0:
        raise ValueError(f"ring_evict_append: r_max={r_max} < 0")


def ring_evict(Ybuf, Wbuf, n_evict: int, t_cur: int) -> None:
    """Plain ``ring_evict``, in place on (T_cap, N) buffers: ``where(t <
    t_cur - n_evict, roll(buf, -n_evict), 0)``.  With ``n_evict = 0`` the
    select reproduces the buffers bit for bit."""
    T_cap = Ybuf.shape[0]
    keep = (torch.arange(T_cap, device=Ybuf.device)
            < t_cur - n_evict)[:, None]
    for buf in (Ybuf, Wbuf):
        buf.copy_(torch.where(keep, torch.roll(buf, -n_evict, dims=0),
                              torch.zeros((), dtype=buf.dtype,
                                          device=buf.device)))


def ring_evict_append_plain(Ybuf, Wbuf, rows, rmask, n_evict: int,
                            t_cur: int) -> None:
    """Plain-torch K13, in place: ``ring_evict``, then ``rows``/``rmask``
    (r_max, N) written at rows t_cur - n_evict + j, the rows past T_cap
    dropped."""
    T_cap, r_max = Ybuf.shape[0], rows.shape[0]
    _check_counts(T_cap, r_max, n_evict, t_cur)
    ring_evict(Ybuf, Wbuf, n_evict, t_cur)
    t_keep = t_cur - n_evict
    n_in = max(0, min(r_max, T_cap - t_keep))
    Ybuf[t_keep:t_keep + n_in] = rows[:n_in]
    Wbuf[t_keep:t_keep + n_in] = rmask[:n_in]


def ring_evict_append(Ybuf, Wbuf, rows, rmask, n_evict: int,
                      t_cur: int) -> None:
    """K13: evict ``n_evict`` rows and append ``rows``/``rmask`` in place
    on ``Ybuf``/``Wbuf`` (see the module docstring).  The kernel assumes
    the session's invariant, every row at and past ``t_cur`` exactly zero
    on entry; under it, kernel and plain twin agree bit for bit.  One
    launch per call on CUDA tensors; no fallback."""
    if Ybuf.device.type == "cpu":
        return ring_evict_append_plain(Ybuf, Wbuf, rows, rmask, n_evict,
                                       t_cur)
    T_cap, N = Ybuf.shape
    r_max = rows.shape[0]
    dt, dev = Ybuf.dtype, Ybuf.device
    _check_counts(T_cap, r_max, n_evict, t_cur)
    for name, x, shape in (("Ybuf", Ybuf, (T_cap, N)),
                           ("Wbuf", Wbuf, (T_cap, N)),
                           ("rows", rows, (r_max, N)),
                           ("rmask", rmask, (r_max, N))):
        kernels.check_tensor(name, x, shape, dt, dev)
    kernels.launch("ring_append", dt, Ybuf, Wbuf, rows, rmask, T_cap, N,
                   r_max, int(n_evict), int(t_cur))


def batched_ring_evict(Ybuf, Wbuf, n_evict, t_cur) -> None:
    """Per-lane ``ring_evict`` on (B, T_cap, N) buffers, in place; (B,)
    integer counts.  Frozen lanes pass ``n_evict = 0`` and hold bit for
    bit."""
    for b, (e, t) in enumerate(zip(n_evict.tolist(), t_cur.tolist())):
        ring_evict(Ybuf[b], Wbuf[b], e, t)


def batched_ring_evict_append_plain(Ybuf, Wbuf, rows, rmask, n_evict,
                                    t_cur) -> None:
    """Plain-torch K13b, in place: ``batched_ring_evict``, then
    ``batched_ragged_append`` at t_cur - n_evict."""
    T_cap, r_max = Ybuf.shape[1], rows.shape[1]
    for e, t in zip(n_evict.tolist(), t_cur.tolist()):
        _check_counts(T_cap, r_max, e, t)
    batched_ring_evict(Ybuf, Wbuf, n_evict, t_cur)
    batched_ragged_append(Ybuf, Wbuf, rows, rmask, t_cur - n_evict)


def batched_ring_evict_append(Ybuf, Wbuf, rows, rmask, n_evict,
                              t_cur) -> None:
    """K13b: per lane, evict ``n_evict[b]`` rows and append ``rows[b]`` /
    ``rmask[b]`` in place on (B, T_cap, N) buffers; ``n_evict`` / ``t_cur``
    are (B,) int32 tensors on the buffers' device, which the kernel reads
    there (no host read).  The caller validates the counts on the host
    (0 <= n_evict <= t_cur <= T_cap); the kernel leaves a lane whose
    counts break that untouched.  Kernel and plain twin agree bit for bit
    under the session invariant (every row at and past t_cur zero).  One
    launch per call on CUDA tensors; no fallback."""
    if Ybuf.device.type == "cpu":
        return batched_ring_evict_append_plain(Ybuf, Wbuf, rows, rmask,
                                               n_evict, t_cur)
    B, T_cap, N = Ybuf.shape
    r_max = rows.shape[1]
    dt, dev = Ybuf.dtype, Ybuf.device
    for name, x, shape, xdt in (("Ybuf", Ybuf, (B, T_cap, N), dt),
                                ("Wbuf", Wbuf, (B, T_cap, N), dt),
                                ("rows", rows, (B, r_max, N), dt),
                                ("rmask", rmask, (B, r_max, N), dt),
                                ("n_evict", n_evict, (B,), torch.int32),
                                ("t_cur", t_cur, (B,), torch.int32)):
        kernels.check_tensor(name, x, shape, xdt, dev)
    kernels.launch("batched_ring_append", dt, Ybuf, Wbuf, rows, rmask,
                   n_evict, t_cur, B, T_cap, N, r_max)


# ---------------------------------------------------------------------------
# The fleet core
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetOptions:
    """Options of a fleet bucket's tick.

    ``fault_tenant`` / ``fault_iter`` / ``fault_drop`` are the
    deterministic chaos seam: subtract ``fault_drop`` from lane
    ``fault_tenant``'s loglik at EM iteration ``fault_iter``, forcing that
    lane, and only that lane, through the divergence path while its
    bucket-mates run bit for bit as without it.
    """

    horizon: int = 1
    di: bool = True
    fault_tenant: Optional[int] = None
    fault_iter: int = 1
    fault_drop: float = 1e6


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to dfm_tpu_torch yet: ROADMAP {item}")


def _batched_lowrank_e_step(Ybuf, Wbuf, p, rank: int):
    """The rank-r masked E-step of every lane at once: K2b-m, K9-basis,
    K9-fwd, K1b-m (its quad_R) and K9-bwd, one launch each, then each
    lane's loglik; lane b gets what the lone ``lowrank_filter`` /
    ``lowrank_smoother`` pair gives on its panel (the JAX fleet's vmap of
    that pair)."""
    stats = ObsStats(*_batched_obs_stats_masked(Ybuf, Wbuf, p.Lam, p.R))
    V = policy_basis(p.Lam, p.R, resolve_rank(p.A.shape[-1], rank))
    xp, Pp, xf, Pf, ld, corr = lowrank_scan(stats.b, stats.C, V, p.A, p.Q,
                                            p.mu0, p.P0)
    quad_R, _ = _batched_quad_masked(Ybuf, Wbuf, p.Lam, p.R, xp, stats.b,
                                     stats.C)
    ll = lowrank_loglik_from_terms(stats, ld, corr, quad_R)
    return (ll, *lowrank_smoother_scan(xp, Pp, xf, Pf, p.A, V))


def _batched_e_step(Ybuf, Wbuf, p, cfg):
    """Batched masked E-step routed by ``cfg.filter``: (loglik (B,) f64,
    x_sm, P_sm, P_lag), batch-major.  ``info``: the masked batched twins
    and K4b-bwd; ``lowrank``: its batched pass; ``pit_qr``: the lone
    masked pair once per lane."""
    if cfg.filter == "info":
        ll, (xp, Pp, xf, Pf) = batched_filter_masked(Ybuf, Wbuf, p)
        return (ll, *_batched_rts(xp, Pp, xf, Pf, p.A))
    if cfg.filter == "lowrank":
        return _batched_lowrank_e_step(Ybuf, Wbuf, p, cfg.rank)
    if cfg.filter == "pit_qr":
        ff, sf = cfg.filter_fn(), cfg.smoother_fn()
        outs = []
        for b in range(Ybuf.shape[0]):
            pb = SSMParams(*(x[b] for x in p))
            kf = ff(Ybuf[b], pb, mask=Wbuf[b])
            sm = sf(kf, pb)
            outs.append((kf.loglik, sm.x_sm, sm.P_sm, sm.P_lag))
        return tuple(torch.stack(v) for v in zip(*outs))
    raise ValueError(f"fleet buckets do not route filter={cfg.filter!r}")


def _fleet_em_scan(Ybuf, Wbuf, p0, tol, floor, iter_cap, tick_act, t_new,
                   cfg, max_iters: int, opts: FleetOptions):
    """Per-lane warm EM: ``max_iters`` iterations with per-lane freezes and
    no host read.  ``tol`` / ``floor`` (B,) f64, ``iter_cap`` (B,) int32,
    ``tick_act`` (B,) bool, ``t_new`` (B,) int32 live lengths.  Each
    iteration applies the lone fit's decision rules (relative tolerance,
    plateau, divergence past the noise floor, a non-finite loglik as
    divergence); a diverging lane rolls back to the params that entered
    the offending update; every carry leaf is committed with
    ``torch.where`` on (B,) masks.  Returns (p, state (B,), n_iters (B,),
    good_it (B,), lls (B, max_iters) f64, NaN past each lane's trace)."""
    acc = accum_dtype()
    i32 = torch.int32
    B, dev = Ybuf.shape[0], Ybuf.device
    nan = torch.full((B,), float("nan"), dtype=acc, device=dev)
    p, p_prev, ll_prev = p0, p0, nan
    state = torch.zeros((B,), dtype=i32, device=dev)
    n_lls = torch.zeros_like(state)
    good_it = torch.zeros_like(state)
    fault = None
    if opts.fault_tenant is not None:
        fault = torch.arange(B, device=dev) == opts.fault_tenant
    recs = []
    for j in range(max_iters):
        ll, x_sm, P_sm, P_lag = _batched_e_step(Ybuf, Wbuf, p, cfg)
        ll = ll.to(acc)
        if fault is not None and j == opts.fault_iter:
            ll = torch.where(fault, ll - opts.fault_drop, ll)
        p_new = batched_m_step_masked(Ybuf, Wbuf, x_sm, P_sm, P_lag, p, cfg,
                                      t_new)
        live = (state == RUNNING) & (n_lls < iter_cap) & tick_act
        n_out = n_lls + live.to(i32)
        # On a lane's first iteration ll_prev is NaN: every comparison is
        # False and only the non-finite rule can fire.
        rel = (ll - ll_prev) / torch.clamp(ll_prev.abs(), min=1e-12)
        drop = ll_prev - ll
        small = (tol > 0) & (rel.abs() < tol)
        diver = ~small & (drop > floor)
        plateau = ~small & ~diver & (drop > 0) & (tol > 0)
        prog = torch.where(small | plateau, CONVERGED,
                           torch.where(diver, DIVERGED, RUNNING)).to(i32)
        prog = torch.where(torch.isfinite(ll), prog, DIVERGED).to(i32)
        advance = live & (prog != DIVERGED)
        roll = live & (prog == DIVERGED)
        p_out = SSMParams(*(
            torch.where(_bmask(advance, n), n,
                        torch.where(_bmask(roll, pv), pv, cur))
            for n, pv, cur in zip(p_new, p_prev, p)))
        p_prev = SSMParams(*(torch.where(_bmask(live, cur), cur, pv)
                             for cur, pv in zip(p, p_prev)))
        p = p_out
        state = torch.where(live, prog, state)
        ll_prev = torch.where(live, ll, ll_prev)
        good_it = torch.where(roll, torch.clamp(n_out - 2, min=0), good_it)
        n_lls = n_out
        recs.append(torch.where(live, ll, nan))
    lls = (torch.stack(recs, dim=1) if recs
           else torch.zeros((B, 0), dtype=acc, device=dev))
    return p, state, n_lls, good_it, lls


def _obs_sd(p, P):
    """Per-lane observation-space one-sigma bands of state covariances P
    (B, k, k): sqrt(max(Lam P Lam' + R, 0)), (B, N)."""
    v = torch.einsum("bnk,bkl,bnl->bn", p.Lam, P, p.Lam) + p.R
    return torch.sqrt(torch.clamp(v, min=0.0))


def _fleet_core(Ybuf, Wbuf, rows, rmask, n_new, n_evict, t_cur, p0, tol,
                floor, iter_cap, tick_act, cfg, max_iters: int,
                opts: FleetOptions) -> dict:
    """One fleet tick on the device, with no host read: K13b (in place on
    ``Ybuf``/``Wbuf``), the per-lane warm EM, the reporting smooth at the
    fitted params, nowcasts, bands, forecasts and the diffusion-index
    forecasts of every lane.

    Ybuf/Wbuf (B, T_cap, N); rows/rmask (B, r_max, N) with exact zeros
    past each lane's count; n_new/n_evict/t_cur/iter_cap (B,) int32;
    tol/floor (B,) f64; tick_act (B,) bool.
    """
    batched_ring_evict_append(Ybuf, Wbuf, rows, rmask, n_evict, t_cur)
    t_new = t_cur - n_evict + n_new
    p_fit, state, n_iters, good_it, lls = _fleet_em_scan(
        Ybuf, Wbuf, p0, tol, floor, iter_cap, tick_act, t_new, cfg,
        max_iters, opts)
    _, x_sm, P_sm, _ = _batched_e_step(Ybuf, Wbuf, p_fit, cfg)
    B, T_cap, k = x_sm.shape
    i_T = torch.clamp(t_new - 1, 0, T_cap - 1).long()
    x_T = x_sm.gather(1, i_T[:, None, None].expand(B, 1, k))[:, 0]
    P_T = P_sm.gather(1, i_T[:, None, None, None].expand(B, 1, k, k))[:, 0]
    f_fore, y_fore, y_sd = [], [], []
    x, P = x_T, P_T
    for _ in range(opts.horizon):
        x = matvec_vpu(p_fit.A, x)
        P = matmul_vpu(matmul_vpu(p_fit.A, P), _bT(p_fit.A)) + p_fit.Q
        f_fore.append(x)
        y_fore.append(torch.einsum("bnk,bk->bn", p_fit.Lam, x))
        y_sd.append(_obs_sd(p_fit, P))
    di = (_di_forecast_batched(x_sm, Ybuf, t_new, opts.horizon)
          if opts.di else None)
    return {"Ybuf": Ybuf, "Wbuf": Wbuf, "p": p_fit, "good_it": good_it,
            "lls": lls, "n_iters": n_iters, "status": state, "x_sm": x_sm,
            "P_sm": P_sm,
            "nowcast": torch.einsum("bnk,bk->bn", p_fit.Lam, x_T),
            "nowcast_sd": _obs_sd(p_fit, P_T),
            "f_fore": torch.stack(f_fore, dim=1),     # (B, h, k)
            "y_fore": torch.stack(y_fore, dim=1),     # (B, h, N)
            "y_sd": torch.stack(y_sd, dim=1),         # (B, h, N)
            "di": di}


def fleet_impl_sharded(*args, **kwargs):
    """The tick with the bucket's lanes split over a mesh of cards: not
    ported yet."""
    raise _not_ported("the sharded fleet tick (fleet_impl_sharded)",
                      "Queue 1 item 12")
