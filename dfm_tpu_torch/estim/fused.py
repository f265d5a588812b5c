"""Fused end-to-end fit: EM to convergence, smooth, nowcast and forecasts.

The PyTorch twin of ``dfm_tpu.estim.fused``.  The JAX package runs EM to
convergence in one ``lax.while_loop`` with the stop rule on the device,
then smooths and forecasts in the same program, and reads the host once.
PyTorch runs eagerly and has no device while-loop, so the loop runs here
as GATED CHUNKS (``em_while_chunk``): each trip runs ``chunk`` EM
iterations through ``em.em_chunk`` and evaluates the JAX predicate on the
device (relative tolerance, plateau, divergence against the absolute
noise floor, a NaN loglik counting as divergence; the last-good
checkpoint by the chunked EM loop's replay rule), and commits its carry
with ``torch.where(status == RUNNING, new, old)``.  That is the
while-loop's own semantics: a stopped loop leaves its carry untouched, so
the result equals the JAX loop's.

Host reads: ``em_while(read_status=False)`` (sessions) runs every chunk
gated and reads nothing; ``em_while(read_status=True)`` (``fit``) reads
the 4-byte status after each chunk but the last and stops there, at most
one blocking read per chunk.  ``read_packed`` then moves every host-bound
output in ONE device->host copy of one packed f64 buffer.  One read per
fit needs the loop in a CUDA graph (ROADMAP Queue 1 item 4).

The diffusion-index forecasts solve N batched (k+2)x(k+2) normal
equations by LU (``torch.linalg.lu_factor_ex`` and ``lu_solve``, library
calls, ROADMAP Queue 2), whose error check would read the host and which
therefore run unchecked, as ``jnp.linalg.solve`` does.  An exactly zero
pivot (the ridge of 1e-8 is below f32's resolution of these sums, and a
rank-r session's factors can leave the equations singular to rounding)
becomes eps x the system's largest pivot, so the forecast stays finite
where the JAX package's LU, rounding differently, lands on a tiny pivot;
every other system is solved as ``solve_ex`` solves it (the same factors
and the same solve).  Not ported here: the guarded
dispatch (``policy=``, ROADMAP Queue 1 item 5), tracing (item 13), the
donated warm-refit twin and the panel residency cache (item 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.precision import accum_dtype, highest_precision
from ..utils import refuse_unported
from .em import EMConfig, _panel_consts, cfg_hypers, em_chunk

__all__ = ["FusedOptions", "FusedRun", "resolve_fused", "run_fused",
           "em_while", "em_while_chunk", "forecast_path", "read_packed",
           "RUNNING", "CONVERGED", "DIVERGED"]

RUNNING, CONVERGED, DIVERGED = 0, 1, 2
_PARAM_KEYS = ("p", "p_prev", "p_good")       # carry entries holding params


@dataclasses.dataclass(frozen=True)
class FusedOptions:
    """Options of the fused fit.

    horizon: forecast steps ahead (state-space iterate + diffusion index).
    di: also compute the diffusion-index (observable-regression) forecast.
    fault_chunk/fault_drop: test seam — subtract ``fault_drop`` from the
    logliks of chunk index ``fault_chunk`` on the device, forcing the
    divergence branch.
    """

    horizon: int = 1
    di: bool = True
    fault_chunk: Optional[int] = None
    fault_drop: float = 1e6


def resolve_fused(fused):
    """Normalize the ``fit(fused=...)`` knob to FusedOptions or None."""
    if not fused:
        return None
    if fused is True:
        return FusedOptions()
    if isinstance(fused, FusedOptions):
        return fused
    if isinstance(fused, int):
        return FusedOptions(horizon=max(1, int(fused)))
    raise TypeError(
        "fused must be bool, int (forecast horizon) or FusedOptions; "
        f"got {type(fused).__name__}")


def _di_solve(Gff, Gfy, Gyy, bf, by, N, d, ridge):
    """Assemble and solve the N (d, d) normal equations of the
    diffusion-index regressions (shared factor block, per-series own lag),
    over any leading lane axes: Gff (..., d-1, d-1), Gfy and bf (..., d-1,
    N), Gyy and by (..., N)."""
    dt, dev = Gff.dtype, Gff.device
    lead = Gyy.shape[:-1]
    XtX = torch.zeros((*lead, N, d, d), dtype=dt, device=dev)
    XtX[..., :d - 1, :d - 1] = Gff[..., None, :, :]
    XtX[..., :d - 1, d - 1] = Gfy.transpose(-1, -2)
    XtX[..., d - 1, :d - 1] = Gfy.transpose(-1, -2)
    XtX[..., d - 1, d - 1] = Gyy
    XtX = XtX + ridge * torch.eye(d, dtype=dt, device=dev)
    Xtz = torch.cat([bf.transpose(-1, -2), by[..., None]], dim=-1)
    LU, piv, _ = torch.linalg.lu_factor_ex(XtX)
    U = LU.diagonal(dim1=-2, dim2=-1)
    tiny = torch.finfo(dt).eps * U.abs().amax(-1, keepdim=True)
    U.copy_(torch.where(U == 0, tiny, U))
    return torch.linalg.lu_solve(LU, piv, Xtz[..., None])[..., 0]


def _di_forecast_core(F, Y, horizon: int, ridge: float = 1e-8):
    """Diffusion-index h-step forecast of every series (f_lags = 0,
    y_lags = 1): the masked form with every row live (all its weights are
    exactly 1)."""
    return _di_forecast_core_masked(F, Y, F.shape[0], horizon, ridge)


def _di_forecast_core_masked(F, Y, t_new: int, horizon: int,
                             ridge: float = 1e-8):
    """``_di_forecast_batched`` for one panel whose first ``t_new`` (host
    integer) rows are live."""
    t = torch.full((1,), t_new, dtype=torch.int64, device=F.device)
    return _di_forecast_batched(F[None], Y[None], t, horizon, ridge)[0]


def _di_forecast_batched(F, Y, t_new, horizon: int, ridge: float = 1e-8):
    """Diffusion-index h-step forecast of every series of B lanes at once,
    F (B, T, k), Y (B, T, N) capacity-padded, ``t_new`` (B,) live lengths
    on the device (no host read): y_{t+h} on [1, F_t, y_{t-1}], one
    regression per column, one batched solve of the B N normal equations.
    The regression rows past a lane's live prefix get exact {0,1} zero
    weights, and its "last" rows are the rows at ``t_new - 1`` /
    ``t_new - 2``, clipped into the buffer."""
    B, T, k = F.shape
    N = Y.shape[-1]
    d = k + 2
    dt, dev = F.dtype, F.device
    L = max(T - 1 - horizon, 0)
    n_fit = torch.clamp(t_new - 1 - horizon, min=0)
    w = (torch.arange(L, device=dev)[None, :] < n_fit[:, None]).to(dt)
    Xf = torch.cat([torch.ones((B, L, 1), dtype=dt, device=dev),
                    F[:, 1:1 + L]], dim=-1)
    Ylag = Y[:, :L]
    Z = Y[:, 1 + horizon:1 + horizon + L]
    XwT = (Xf * w[..., None]).transpose(-1, -2)
    beta = _di_solve(XwT @ Xf, XwT @ Ylag,
                     torch.einsum("bt,bti,bti->bi", w, Ylag, Ylag),
                     XwT @ Z, torch.einsum("bt,bti,bti->bi", w, Ylag, Z),
                     N, d, ridge)
    row = lambda i: torch.clamp(i, 0, T - 1).long()[:, None, None]  # noqa: E731
    f_last = F.gather(1, row(t_new - 1).expand(B, 1, k))     # (B, 1, k)
    y_prev = Y.gather(1, row(t_new - 2).expand(B, 1, N))[:, 0]
    x_last = torch.cat([torch.ones((B, N, 1), dtype=dt, device=dev),
                        f_last.expand(B, N, k), y_prev[..., None]], dim=-1)
    return torch.einsum("bnd,bnd->bn", x_last, beta)


def _sel(pred, a, b):
    """``where(pred, a, b)`` over two params tuples (pred a 0-d bool)."""
    return type(a)(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def em_while_init(p0, max_iters: int, chunk: int) -> dict:
    """The while-loop's initial carry, on p0's device."""
    dev = p0.A.device
    i64 = torch.int64
    n_chunks = -(-max_iters // chunk)
    zero = torch.zeros((), dtype=i64, device=dev)
    return {"p": p0, "p_prev": p0, "prev_it": zero, "p_good": p0,
            "good_it": zero,
            "lls": torch.full((n_chunks * chunk,), float("nan"),
                              dtype=accum_dtype(), device=dev),
            "ll_last": torch.full((), float("nan"), dtype=accum_dtype(),
                                  device=dev),
            "it": zero,
            "status": torch.full((), RUNNING, dtype=i64, device=dev)}


def em_while_chunk(carry: dict, c: int, Y, m, tol: float, noise_floor: float,
                   cfg: EMConfig, max_iters: int, chunk: int,
                   opts: FusedOptions, consts=None, n_steps=None) -> dict:
    """Trip ``c`` of the EM while-loop (``dfm_tpu.estim.fused._em_while_core``
    ``step``), gated: the returned carry equals ``carry`` unless its
    status was RUNNING.  While the loop runs, its iteration counter is
    ``c * chunk``, so the live cap ``n_active`` is a host integer.  No
    host read."""
    C = chunk
    it0 = c * C
    n_active = max(0, min(C, max_iters - it0))
    p = carry["p"]
    p_end, lls_c = em_chunk(Y, p, C, n_active, mask=m, cfg=cfg,
                            consts=consts, n_steps=n_steps)
    if opts.fault_chunk is not None and c == opts.fault_chunk:
        lls_c = lls_c - opts.fault_drop
    dev = lls_c.device
    active = torch.arange(C, device=dev) < n_active
    prev = torch.cat([carry["ll_last"][None], lls_c[:-1]])
    has_prev = torch.isfinite(prev)
    rel = (lls_c - prev) / torch.clamp(prev.abs(), min=1e-12)
    drop = prev - lls_c
    small = (rel.abs() < tol) & (tol > 0)
    monotone = cfg_hypers(cfg) is None
    diver = ~small & (drop > noise_floor) & monotone
    plateau = ~small & ~diver & (drop > 0) & (tol > 0)
    conv = has_prev & active & (small | plateau)
    dive = active & ((has_prev & diver) | ~torch.isfinite(lls_c))
    stop = conv | dive
    any_stop = stop.any()
    first = torch.argmax(stop.to(torch.int32))
    stopped_div = any_stop & dive.gather(0, first.view(1))[0]
    status = torch.where(any_stop, torch.where(stopped_div, DIVERGED,
                                               CONVERGED), RUNNING)
    consumed = torch.where(any_stop, first + 1, n_active)
    # Last-good checkpoint (the chunked EM loop's replay rule): a drop at
    # this chunk's first loglik blames the previous chunk's update.
    cand_p = _sel(first >= 1, p, carry["p_prev"])
    cand_it = torch.where(first >= 1, it0, carry["prev_it"])
    lls = carry["lls"].clone()
    lls[it0:it0 + C] = lls_c
    new = {"p": p_end, "p_prev": p, "prev_it": carry["it"],
           "p_good": _sel(stopped_div, cand_p, carry["p_good"]),
           "good_it": torch.where(stopped_div, cand_it, carry["good_it"]),
           "lls": lls, "ll_last": lls_c[max(n_active - 1, 0)],
           "it": carry["it"] + consumed,
           "status": status.to(torch.int64)}
    running = carry["status"] == RUNNING
    return {key: (_sel if key in _PARAM_KEYS else torch.where)(
                running, val, carry[key])
            for key, val in new.items()}


def em_while(Y, m, p0, tol: float, noise_floor: float, cfg: EMConfig,
             max_iters: int, chunk: int, opts: FusedOptions, consts=None,
             n_steps=None, read_status: bool = False):
    """EM to convergence as gated chunks (``_em_while_core``).  Returns
    (final carry, blocking status reads made).  ``read_status`` reads the
    carry's status after each chunk but the last and stops once it is no
    longer RUNNING; without it nothing is read."""
    n_chunks = -(-max_iters // chunk)
    carry = em_while_init(p0, max_iters, chunk)
    reads = 0
    for c in range(n_chunks):
        carry = em_while_chunk(carry, c, Y, m, tol, noise_floor, cfg,
                               max_iters, chunk, opts, consts=consts,
                               n_steps=n_steps)
        if read_status and c < n_chunks - 1:
            reads += 1
            if int(carry["status"]) != RUNNING:      # 4-byte blocking read
                break
    return carry, reads


def forecast_path(p, x_T, P_T, horizon: int):
    """Iterate the factor dynamics ``horizon`` steps from (x_T, P_T):
    (f_fore (h, k), y_fore (h, N), y_sd (h, N)), with the one-sigma
    observation bands y_sd = sqrt(max(Lam P Lam' + R, 0))."""
    x, P = x_T, P_T
    fs, ys, sds = [], [], []
    for _ in range(horizon):
        x = p.A @ x
        P = p.A @ P @ p.A.T + p.Q
        fs.append(x)
        ys.append(p.Lam @ x)
        sds.append(obs_sd(p, P))
    return torch.stack(fs), torch.stack(ys), torch.stack(sds)


def obs_sd(p, P):
    """Observation-space one-sigma band of a state covariance P."""
    v = torch.einsum("nk,kl,nl->n", p.Lam, P, p.Lam) + p.R
    return torch.sqrt(torch.clamp(v, min=0.0))


def read_packed(named: dict) -> dict:
    """Every host-bound tensor of ``named`` (None entries pass through) in
    ONE blocking device->host copy: the tensors are cast to f64 and packed
    into one buffer on their device, copied, and split on the host into
    float64 NumPy arrays of their shapes."""
    keys = [k for k, v in named.items() if v is not None]
    flat = torch.cat([named[k].reshape(-1).to(torch.float64) for k in keys])
    host = flat.cpu().numpy()                  # the one blocking read
    out, off = {}, 0
    for k in keys:
        shape = tuple(named[k].shape)
        n = math.prod(shape)
        out[k] = host[off:off + n].reshape(shape)
        off += n
    out.update({k: None for k, v in named.items() if v is None})
    return out


def _fused_fit_core(Y, mask, p0, tol, noise_floor, cfg, max_iters, chunk,
                    opts):
    m = mask
    consts = _panel_consts(Y, m is not None, cfg)
    f, reads = em_while(Y, m, p0, tol, noise_floor, cfg, max_iters, chunk,
                        opts, consts=consts, read_status=True)
    p_fit = f["p"]
    _, sm = cfg.report_smooth(Y, m, p_fit)
    x_T, P_T = sm.x_sm[-1], sm.P_sm[-1]
    f_fore, y_fore, _ = forecast_path(p_fit, x_T, P_T, opts.horizon)
    out = {"lls": f["lls"], "n_iters": f["it"],
           "status": f["status"], "good_it": f["good_it"],
           "x_sm": sm.x_sm, "P_sm": sm.P_sm, "nowcast": p_fit.Lam @ x_T,
           "f_fore": f_fore, "y_fore": y_fore,
           "di": _di_forecast_core(sm.x_sm, Y, opts.horizon)
           if opts.di else None}
    for name, p in (("p", p_fit), ("p_good", f["p_good"])):
        out.update({f"{name}.{field}": x
                    for field, x in zip(p._fields, p)})
    return out, reads


@dataclasses.dataclass
class FusedRun:
    """Host-side view of one fused fit (every field NumPy)."""

    params: object
    p_good: object
    good_it: int
    lls: np.ndarray
    n_iters: int
    converged: bool
    diverged: bool
    x_sm: np.ndarray
    P_sm: np.ndarray
    nowcast: np.ndarray
    f_fore: np.ndarray
    y_fore: np.ndarray
    di: Optional[np.ndarray]
    host_reads: int = 1          # blocking device->host reads of the fit


def _params_of(host: dict, name: str):
    from ..backends.cpu_ref import SSMParams as NpParams
    return NpParams(*(host[f"{name}.{f}"]
                      for f in ("Lam", "A", "Q", "R", "mu0", "P0")))


def _read_run(out: dict, max_iters: int, status_reads: int) -> FusedRun:
    host = read_packed(out)
    n = min(int(host["n_iters"]), max_iters)
    status = int(host["status"])
    return FusedRun(
        params=_params_of(host, "p"), p_good=_params_of(host, "p_good"),
        good_it=int(host["good_it"]), lls=host["lls"][:n], n_iters=n,
        converged=status == CONVERGED,
        diverged=status == DIVERGED, x_sm=host["x_sm"], P_sm=host["P_sm"],
        nowcast=host["nowcast"], f_fore=host["f_fore"],
        y_fore=host["y_fore"], di=host["di"],
        host_reads=status_reads + 1)


def run_fused(Y, mask, p0, cfg: EMConfig, max_iters: int, tol: float,
              noise_floor: float, opts: FusedOptions,
              fused_chunk: int = 8, policy=None, health=None,
              p0_host=None) -> FusedRun:
    """The fused fit on device tensors (``Y``, ``mask`` or None, params
    ``p0``): EM to convergence, the reporting smooth
    (``EMConfig.report_pair``), nowcast, state-space and diffusion-index
    forecasts; returns a host-side ``FusedRun``.  The JAX keywords of the
    guarded fused fit, ``policy``, ``health`` and ``p0_host``, raise when
    given (ROADMAP Queue 1 item 5)."""
    refuse_unported("run_fused", ("policy", policy is not None, 5),
                    ("health", health is not None, 5),
                    ("p0_host", p0_host is not None, 5))
    max_iters = max(1, int(max_iters))
    C = max(1, int(fused_chunk))
    with highest_precision():
        out, reads = _fused_fit_core(Y, mask, p0, tol, noise_floor, cfg,
                                     max_iters, C, opts)
        return _read_run(out, max_iters, reads)
