"""Streaming nowcast sessions: one blocking device->host read per query.

The PyTorch twin of ``dfm_tpu.serve.session`` for one tenant.  The query
loop is "here is this month's ragged-edge panel update, give me the
nowcast now":

- The standardized panel and its {0,1} mask live on the device in a
  capacity-padded (T_cap, N) buffer (``estim.batched.pad_panel_to_t``:
  zero rows with a zero mask, which the masked filters and M-step treat
  as inert).
- ``update(new_rows)`` (1) uploads the update's rows, padded to the row
  budget; (2) runs, with no device->host synchronization, kernel K13
  (``serve.batched.ring_evict_append``: ring eviction and the append, in
  place), the warm EM (``estim.fused.em_while`` with the live length
  ``n_steps``, so the t-masked M-step divides by the true transition
  count), the reporting smooth, the nowcast and its bands, the
  state-space forecasts and the diffusion-index forecast; on divergence
  the resident params become the last-good checkpoint by a device-side
  select; (3) reads every host-bound output in ONE packed read
  (``_read``).  ``NowcastSession.check_sync = True`` runs step (2) under
  ``torch.cuda.set_sync_debug_mode("error")``, so any hidden
  synchronization raises.
- Capacity overflow and row-budget violations raise on the host before
  any device work.  ``ring=True`` turns the buffer into a ring: an update
  past capacity retires the oldest rows instead of raising, and the
  session holds the trailing ``capacity``-row window.
- ``snapshot(path)`` / ``open_session(snapshot=path)`` write and read the
  JAX package's session npz (``utils.checkpoint``), so a snapshot of
  either package restores in the other.

The live length, the row count and the eviction count are host integers
(the session tracks them), passed to the kernels as arguments; a CUDA
graph of the query, which would make them device scalars, is a later
step.  Not ported yet, each raising ``NotImplementedError``: the
self-healing guard (``robust=`` other than None/False; ROADMAP Queue 1
item 5: without faults the guarded and unguarded paths give the same
numbers), request tracing and the live plane (``trace=``,
``accounting()``; item 13).  The ``pit`` engine runs the
covariance-form parallel-in-time E-step (K14) over the whole capacity.
The ``lowrank`` engine serves at the backend's (or ``rank=``) rank r; its
reporting smooth is its own rank-r pair, so its bands are the
conservative rank-r ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..estim.batched import pad_panel_to_t
from ..estim.em import EMConfig, noise_floor_for
from ..estim.fused import (CONVERGED, DIVERGED, FusedOptions,
                           _di_forecast_core_masked, _sel, em_while,
                           forecast_path, obs_sd, read_packed)
from ..ops.precision import highest_precision
from ..robust.health import FitHealth
from ..ssm.params import SSMParams
from ..utils.data import Standardizer, build_mask
from .batched import ring_evict_append

__all__ = ["NowcastSession", "SessionUpdate", "open_session"]

_SESSION_IDS = itertools.count(1)

# Engines a session can route (EMConfig.filter values whose masked filter
# and smoother serve a capacity-padded panel).
_SERVE_FILTERS = ("dense", "info", "pit", "pit_qr", "lowrank")

# The 90% two-sided band the serving layer reports coverage against.
_Z90 = 1.6448536269514722


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to dfm_tpu_torch yet: ROADMAP Queue 1 {item}")


def _resolve_serve_engine(b, res_filter, filter, rank, N):
    """A session's (engine, rank): an explicit ``filter=`` wins;
    otherwise the fit's resolved engine when it can serve a masked panel,
    else the backend's masked pick.  The rank (``rank=``, else the
    backend's) rides only with lowrank; every other engine gets 0."""
    if filter is not None:
        flt = str(filter)
        if flt not in _SERVE_FILTERS:
            raise ValueError(
                f"unknown serving filter {filter!r}; sessions route "
                f"{_SERVE_FILTERS}")
    else:
        flt = (res_filter if res_filter in _SERVE_FILTERS
               else b._filter_for(N, True))
    r = int(getattr(b, "rank", 0) if rank is None else rank)
    return flt, (r if flt == "lowrank" else 0)


def _check_robust(robust) -> None:
    if robust not in (None, False):
        raise _not_ported("robust= (the self-healing session guard)",
                          "item 5")


def _session_core(Ybuf, Wbuf, rows, rmask, n_new: int, n_evict: int,
                  t_cur: int, p0: SSMParams, tol: float, floor: float,
                  cfg: EMConfig, max_iters: int, chunk: int,
                  opts: FusedOptions) -> dict:
    """One query on the device, with no host read: evict and append (K13,
    in place on ``Ybuf``/``Wbuf``), warm EM on the live length, smooth,
    nowcast and bands, forecasts.  ``rows``/``rmask`` are (r_max, N) with
    exact-zero rows past ``n_new``."""
    ring_evict_append(Ybuf, Wbuf, rows, rmask, n_evict, t_cur)
    t_new = t_cur - n_evict + n_new
    f, _ = em_while(Ybuf, Wbuf, p0, tol, floor, cfg, max_iters, chunk, opts,
                    n_steps=t_new)
    p_fit = f["p"]
    _, sm = cfg.report_smooth(Ybuf, Wbuf, p_fit)
    i_T = min(max(t_new - 1, 0), Ybuf.shape[0] - 1)
    x_T, P_T = sm.x_sm[i_T], sm.P_sm[i_T]
    f_fore, y_fore, y_sd = forecast_path(p_fit, x_T, P_T, opts.horizon)
    return {
        # The params the session keeps: last-good on divergence, by a
        # device-side select.
        "p_next": _sel(f["status"] == DIVERGED, f["p_good"], p_fit),
        "status": f["status"], "n_iters": f["it"], "good_it": f["good_it"],
        "lls": f["lls"], "x_sm": sm.x_sm, "P_sm": sm.P_sm,
        "nowcast": p_fit.Lam @ x_T, "nowcast_sd": obs_sd(p_fit, P_T),
        "f_fore": f_fore, "y_fore": y_fore, "y_sd": y_sd,
        "di": (_di_forecast_core_masked(sm.x_sm, Ybuf, t_new, opts.horizon)
               if opts.di else None),
    }


# The outputs of a query that cross to the host, in its one read.
_HOST_KEYS = ("status", "n_iters", "good_it", "lls", "nowcast", "nowcast_sd",
              "f_fore", "y_fore", "y_sd", "di", "x_sm", "P_sm")


@dataclasses.dataclass
class SessionUpdate:
    """Host-side view of one ``NowcastSession.update`` (original units)."""

    nowcast: np.ndarray        # (N,) end-of-sample nowcast, original units
    forecasts: dict            # {"y": (h, N), "f": (h, k), "di": (N,)|None}
    logliks: np.ndarray        # per-iteration loglik path of this update
    n_iters: int               # EM iterations this update consumed
    converged: bool
    diverged: bool
    factors: np.ndarray        # (t, k) smoothed factor means, live prefix
    factor_cov: np.ndarray     # (t, k, k) smoothed covariances
    t: int                     # live panel length after this update
    wall_s: float
    # One-sigma bands (original units); ``coverage`` is the observed
    # fraction of THIS update's new rows inside the PREVIOUS query's 90%
    # band (None for the first query or a pure re-forecast).
    nowcast_sd: Optional[np.ndarray] = None    # (N,)
    forecast_sd: Optional[np.ndarray] = None   # (h, N)
    coverage: Optional[float] = None


class NowcastSession:
    """Device-resident streaming nowcast session (see the module
    docstring).  Open with ``open_session(res, Y)`` or
    ``fit(..., keep_session=True)``; each ``update(new_rows, mask=None)``
    appends the rows and returns a ``SessionUpdate``."""

    # True: run each query's device work under
    # torch.cuda.set_sync_debug_mode("error") (CUDA sessions), so a hidden
    # device->host synchronization raises instead of passing silently.
    check_sync = False

    def __init__(self, res, Y, mask=None, *, capacity: Optional[int] = None,
                 max_update_rows: int = 8, max_iters: int = 5,
                 tol: float = 1e-6, horizon: Optional[int] = None,
                 di: Optional[bool] = None, ring: bool = False,
                 filter: Optional[str] = None, rank: Optional[int] = None,
                 backend=None, robust=None):
        from ..api import DynamicFactorModel, FitResult, TorchBackend
        if not isinstance(res, FitResult):
            raise TypeError(
                f"open_session needs a FitResult; got {type(res).__name__}")
        if not isinstance(res.model, DynamicFactorModel):
            raise TypeError(
                f"sessions support DynamicFactorModel fits only; got "
                f"{type(res.model).__name__}")
        _check_robust(robust)
        b = TorchBackend() if backend is None else backend
        Y = np.asarray(Y, dtype=np.float64)
        if Y.ndim != 2:
            raise ValueError(f"Y must be (T, N); got shape {Y.shape}")
        T0, N = Y.shape
        Lam = np.asarray(res.params.Lam)
        if Lam.shape[0] != N:
            raise ValueError(
                f"FitResult params are for N={Lam.shape[0]} series but the "
                f"panel has N={N}")
        opts = FusedOptions(
            horizon=1 if horizon is None else max(1, int(horizon)),
            di=True if di is None else bool(di))
        if T0 < opts.horizon + 3:
            raise ValueError(
                f"session needs T >= horizon + 3 = {opts.horizon + 3} "
                f"live rows to anchor the forecast regressions; got T={T0}")
        capacity = 2 * T0 if capacity is None else int(capacity)
        if capacity < T0:
            raise ValueError(f"capacity={capacity} < panel length T={T0}")
        if ring and max_update_rows > capacity:
            raise ValueError(
                f"ring mode needs max_update_rows <= capacity so an "
                f"update never evicts more rows than it appends; got "
                f"max_update_rows={max_update_rows} > capacity={capacity}")
        engine = _resolve_serve_engine(b, getattr(res, "filter", None),
                                       filter, rank, N)
        # Frozen standardizer: incoming rows are transformed with the
        # OPEN-time stats (re-standardizing per query would re-unit the
        # device-resident params).
        std = res.standardizer
        Yz = std.transform(Y) if std is not None else Y
        W = build_mask(Y, mask)
        Yz = np.where(W > 0, np.nan_to_num(Yz), 0.0)
        self._setup(b, res.model, res.params, std, Yz, W, engine, opts,
                    capacity=capacity, ring=ring, t_total=T0,
                    max_update_rows=max_update_rows, max_iters=max_iters,
                    tol=tol, n_queries=0)

    def _setup(self, b, model, params, std, Y_live, W_live, engine, opts, *,
               capacity, ring, t_total, max_update_rows, max_iters, tol,
               n_queries):
        """Host shadows, the device buffers and params, and the config
        (shared by ``__init__`` and ``restore``)."""
        self._backend = b
        self._dt, self._dev = b.dtype, b.device
        self._model = model
        self._std = std
        self._opts = opts
        # Host shadows (standardized units, capacity-padded, f64): the
        # snapshot source.  Pure NumPy: keeping them costs no transfer.
        # They are a ring: physical row (_h0 + t) % capacity holds live
        # row t, so mirroring an eviction moves _h0 and no row.
        self._Yhost = np.asarray(pad_panel_to_t(Y_live, capacity), np.float64)
        self._Whost = np.asarray(pad_panel_to_t(W_live, capacity), np.float64)
        self._h0 = 0
        self._capacity = int(capacity)
        self._upload_panel()
        self._p = SSMParams.from_numpy(params, dtype=self._dt,
                                       device=self._dev)
        flt, rank = engine
        self._cfg = EMConfig(estimate_A=model.estimate_A,
                             estimate_Q=model.estimate_Q,
                             estimate_init=model.estimate_init, filter=flt,
                             rank=rank)
        self._N = self._Yhost.shape[1]
        self._t = Y_live.shape[0]
        self._t_total = int(t_total)
        self._ring = bool(ring)
        self._r_max = max(1, int(max_update_rows))
        self._max_iters = max(1, int(max_iters))
        self._tol = float(tol)
        self._chunk = b.fused_chunk
        self._closed = False
        self._n_queries = int(n_queries)
        self._last_band = None     # (y_fore, y_sd) of the previous query
        self._sid = f"s{next(_SESSION_IDS)}"
        self.health = FitHealth(engine="serve")

    # -- introspection -------------------------------------------------
    @property
    def t(self) -> int:
        """Live panel length."""
        return self._t

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def ring(self) -> bool:
        """True if the session evicts its oldest rows past capacity."""
        return self._ring

    @property
    def filter(self) -> str:
        """Resolved serving engine."""
        return self._cfg.filter

    @property
    def rank(self) -> int:
        """The lowrank conditioning rank as asked (<= 0: auto); 0 outside
        ``filter="lowrank"``."""
        return self._cfg.rank

    @property
    def key(self) -> str:
        """The query program's shape key, in the JAX session's format:
        buffer shape and dtype, engine (with ``rank{r}`` for lowrank), row
        budget, EM chunk and iteration budget."""
        parts = ["x".join(map(str, self._Ybuf.shape))
                 + "x" + str(self._dt).replace("torch.", ""),
                 self._cfg.filter]
        if self._cfg.filter == "lowrank":
            parts.append(f"rank{self._cfg.rank}")
        parts += [f"rows{self._r_max}", f"chunk{self._chunk}",
                  f"max{self._max_iters}"]
        return "/".join(parts)

    @property
    def total_rows(self) -> int:
        """Rows the session has ever held, evicted ones included."""
        return self._t_total

    @property
    def n_evicted(self) -> int:
        """Rows retired by the ring buffer so far (0 outside ring mode)."""
        return self._t_total - self._t

    @property
    def remaining(self) -> Optional[int]:
        """Rows that can still be appended before capacity overflow; None
        in ring mode (the stream is unbounded)."""
        if self._ring:
            return None
        return self._capacity - self._t

    @property
    def session_id(self) -> str:
        return self._sid

    def params(self):
        """Current device-resident params as host NumPy (one read)."""
        self._check_open()
        return self._p.to_numpy()

    def _check_open(self):
        if self._closed:
            raise RuntimeError("session is closed")

    # -- the query path ------------------------------------------------
    def update(self, new_rows=None, mask=None, trace=None) -> SessionUpdate:
        """Append ``new_rows`` ((n, N) or (N,), original units; NaN =
        missing, ``mask`` optional {0,1}) and re-estimate: warm EM,
        smooth, nowcast and forecasts, with one blocking read.
        ``new_rows=None`` is a pure re-forecast query (no append).  All
        validation happens on the host before any device work."""
        self._check_open()
        if trace is not None:
            raise _not_ported("update(trace=) (request tracing)", "item 13")
        if new_rows is None:
            if mask is not None:
                raise ValueError(
                    "mask requires new_rows (a pure re-forecast query "
                    "appends nothing)")
            rows = np.zeros((0, self._N))
        else:
            rows = np.asarray(new_rows, dtype=np.float64)
            if rows.ndim == 1:
                rows = rows[None, :]
            if rows.ndim != 2 or rows.shape[1] != self._N:
                raise ValueError(
                    f"new_rows must be (n, {self._N}) or ({self._N},); "
                    f"got shape {np.asarray(new_rows).shape}")
            if rows.shape[0] == 0:
                raise ValueError("new_rows is empty (pass None for a "
                                 "pure re-forecast query)")
        n_new = rows.shape[0]
        if n_new > self._r_max:
            raise ValueError(
                f"update has {n_new} rows but the session was opened with "
                f"max_update_rows={self._r_max}; open with a larger row "
                "budget")
        n_evict = 0
        if self._t + n_new > self._capacity:
            if not self._ring:
                raise ValueError(
                    f"capacity overflow: session holds {self._t} rows of "
                    f"{self._capacity} and cannot take {n_new} more; open "
                    "with ring=True to evict the oldest rows in place "
                    "(unbounded stream at constant memory), or open a "
                    "fresh session with a larger capacity")
            n_evict = self._t + n_new - self._capacity
        W_rows = build_mask(rows, mask)
        rz = self._std.transform(rows) if self._std is not None else rows
        rz = np.where(W_rows > 0, np.nan_to_num(rz), 0.0)
        pad = self._r_max - n_new
        if pad:   # exact-zero fill past n_new: lands on zero-masked slots
            rz = np.concatenate([rz, np.zeros((pad, self._N))], axis=0)
            W_rows = np.concatenate([W_rows, np.zeros((pad, self._N))],
                                    axis=0)
        t_mid = self._t - n_evict
        t_new = t_mid + n_new
        coverage = None
        if n_new and self._last_band is not None:
            pf, ps = self._last_band
            n_cmp = min(n_new, pf.shape[0])
            obs = W_rows[:n_cmp] > 0
            if obs.any():
                err = np.abs(rows[:n_cmp] - pf[:n_cmp])
                coverage = float(np.mean((err <= _Z90 * ps[:n_cmp])[obs]))
        # Absolute loglik noise floor at the LIVE panel size, the floor a
        # cold fit of the extended panel would use.
        floor = noise_floor_for(self._dt, t_new * self._N,
                                mult=self._cfg.noise_floor_mult)
        t0 = time.perf_counter()
        rows_t = self._backend.tensor(rz)                       # (1) upload
        rmask_t = self._backend.tensor(W_rows)
        try:
            with highest_precision(), self._sync_guard():       # (2)
                out = _session_core(self._Ybuf, self._Wbuf, rows_t, rmask_t,
                                    n_new, n_evict, self._t, self._p,
                                    self._tol, floor, self._cfg,
                                    self._max_iters, self._chunk, self._opts)
            host = self._read(out)                               # (3)
        except BaseException:
            # K13 may already have shifted or appended the device panel
            # in place; the host state is still the pre-query one.
            self._upload_panel()
            raise
        wall = time.perf_counter() - t0
        self._p = out["p_next"]
        # The kernel's eviction and append, mirrored on the host shadows:
        # the eviction moves the ring origin.  The evicted rows come back
        # as live rows t_mid.. and are overwritten here (an update evicts
        # only to land at capacity, and never more rows than it brings);
        # every other row past t_new was zero and stays so.
        self._h0 = (self._h0 + n_evict) % self._capacity
        new = self._host_rows(t_mid, t_new)
        self._Yhost[new] = rz[:n_new]
        self._Whost[new] = W_rows[:n_new]
        self._t = t_new
        self._t_total += n_new
        self._n_queries += 1
        status = int(host["status"])
        diverged = status == DIVERGED
        if diverged:
            warnings.warn(
                f"session update diverged after {int(host['good_it'])} good "
                "iterations; keeping the last-good params (this update's "
                "nowcast/forecasts reflect the pre-divergence state only "
                "loosely — consider a cold refit)", RuntimeWarning,
                stacklevel=2)
        inv = self._std.inverse if self._std is not None else (lambda a: a)
        # Bands destandardize by the scale alone.
        sd_inv = ((lambda s: s * self._std.scale) if self._std is not None
                  else (lambda s: s))
        y_fore = np.asarray(inv(host["y_fore"]))
        fore_sd = np.asarray(sd_inv(host["y_sd"]))
        self._last_band = (y_fore, fore_sd)
        di = host["di"]
        n = min(int(host["n_iters"]), self._max_iters)
        return SessionUpdate(
            nowcast=np.asarray(inv(host["nowcast"])),
            forecasts={"y": y_fore, "f": host["f_fore"],
                       "di": np.asarray(inv(di)) if di is not None else None},
            logliks=host["lls"][:n], n_iters=n,
            converged=status == CONVERGED, diverged=diverged,
            factors=host["x_sm"][:t_new], factor_cov=host["P_sm"][:t_new],
            t=t_new, wall_s=wall,
            nowcast_sd=np.asarray(sd_inv(host["nowcast_sd"])),
            forecast_sd=fore_sd, coverage=coverage)

    def _host_rows(self, lo: int, hi: int) -> np.ndarray:
        """Physical rows of the host shadows holding live rows [lo, hi)."""
        return (self._h0 + np.arange(lo, hi)) % self._capacity

    def _upload_panel(self):
        """The device panel from the host shadows (in live-row order), in
        one upload each; never a view of the shadows, which the host
        mirror of each update edits.  A session whose upload fails is
        left closed."""
        self._closed = True
        rows = self._host_rows(0, self._capacity)
        self._Ybuf = torch.tensor(self._Yhost[rows], dtype=self._dt,
                                  device=self._dev)
        self._Wbuf = torch.tensor(self._Whost[rows], dtype=self._dt,
                                  device=self._dev)
        self._closed = False

    def _sync_guard(self):
        """``check_sync`` on a CUDA session: a context in which any
        device->host synchronization raises."""
        if not (self.check_sync and self._dev.type == "cuda"):
            return contextlib.nullcontext()
        return _sync_debug_error()

    def _read(self, out: dict) -> dict:
        """The query's one blocking device->host read: every host-bound
        output, packed (``estim.fused.read_packed``)."""
        return read_packed({k: out[k] for k in _HOST_KEYS})

    # -- maintenance ----------------------------------------------------
    def swap_params(self, params) -> None:
        """Hot-swap the resident params (NumPy, in THIS session's
        standardized scale): one upload; panel, ring ledger and engine
        are untouched.  Swapping bit-equal params is a bit-identical
        no-op."""
        self._check_open()
        Lam = np.asarray(params.Lam, np.float64)
        want = (self._N, self._model.n_factors)
        if tuple(Lam.shape) != want:
            raise ValueError(
                f"swap_params: Lam has shape {tuple(Lam.shape)}, session "
                f"serves (N, k)={want}")
        self._p = SSMParams.from_numpy(params, dtype=self._dt,
                                       device=self._dev)

    def accounting(self) -> dict:
        """The live plane's per-session ledger: not ported yet."""
        raise _not_ported("accounting() (the live plane)", "item 13")

    # -- durability ----------------------------------------------------
    def snapshot(self, path: str) -> str:
        """Durable session snapshot in the JAX package's npz format:
        params + live standardized panel + session config in one atomic
        file (``utils.checkpoint``, content-fingerprinted).  Restore with
        ``open_session(snapshot=path)``.  One explicit params read; the
        panel comes from the host shadows."""
        self._check_open()
        from ..utils.checkpoint import panel_fingerprint, save_checkpoint
        p_np = self._p.to_numpy()
        live = self._host_rows(0, self._t)
        Y_live = self._Yhost[live]
        W_live = self._Whost[live]
        m = self._model
        extra = {
            "session_format": 1,
            "Y_live": Y_live,
            "W_live": W_live,
            "std_mean": (self._std.mean if self._std is not None
                         else np.zeros(0)),
            "std_scale": (self._std.scale if self._std is not None
                          else np.zeros(0)),
            "capacity": self._capacity,
            "ring": self._ring,
            "filter": self._cfg.filter,
            "rank": self._cfg.rank,
            "t_total": self._t_total,
            "max_update_rows": self._r_max,
            "max_iters": self._max_iters,
            "tol": self._tol,
            "horizon": self._opts.horizon,
            "di": self._opts.di,
            "n_queries": self._n_queries,
            "model_n_factors": m.n_factors,
            "model_dynamics": m.dynamics,
            "model_standardize": m.standardize,
            "model_estimate_init": m.estimate_init,
            "drift_state": "",      # no live-plane drift detector yet
        }
        save_checkpoint(path, p_np, it=self._t, logliks=[],
                        fingerprint=panel_fingerprint(Y_live, W_live),
                        converged=False, extra=extra)
        return path

    @classmethod
    def restore(cls, path: str, *, backend=None, robust=None,
                capacity: Optional[int] = None, ring: Optional[bool] = None,
                filter: Optional[str] = None,
                rank: Optional[int] = None) -> "NowcastSession":
        """Rebuild a warm session from ``snapshot(path)`` (either
        package's).  The stored panel is checked against its content
        fingerprint.  ``capacity``/``ring`` override the stored values; a
        capacity smaller than the stored live length keeps the TRAILING
        ``capacity`` rows and needs ring mode."""
        from ..api import DynamicFactorModel, TorchBackend
        from ..backends.cpu_ref import SSMParams as NpParams
        from ..utils.checkpoint import (_FIELDS, check_schema_version,
                                        panel_fingerprint)
        _check_robust(robust)
        meta_keys = ("capacity", "max_update_rows", "max_iters", "tol",
                     "horizon", "di", "n_queries", "model_n_factors",
                     "model_dynamics", "model_standardize",
                     "model_estimate_init")
        with np.load(path) as z:
            check_schema_version(z, path)
            if "session_format" not in z.files:
                raise ValueError(
                    f"{path!r} is not a session snapshot (no "
                    "session_format field) — a plain EM checkpoint "
                    "cannot rebuild a session; open one with "
                    "open_session(res, Y)")
            params = NpParams(*(np.asarray(z[f], np.float64)
                                for f in _FIELDS))
            Y_live = np.asarray(z["Y_live"], np.float64)
            W_live = np.asarray(z["W_live"], np.float64)
            fp = str(z["fingerprint"]) if "fingerprint" in z.files else ""
            mean = np.asarray(z["std_mean"], np.float64)
            scale = np.asarray(z["std_scale"], np.float64)
            meta = {k: z[k][()] for k in meta_keys}
            meta["ring"] = z["ring"][()] if "ring" in z.files else False
            meta["t_total"] = (z["t_total"][()] if "t_total" in z.files
                               else Y_live.shape[0])
            meta["filter"] = (str(z["filter"][()]) if "filter" in z.files
                              else "")
            meta["rank"] = int(z["rank"][()]) if "rank" in z.files else 0
        if fp and panel_fingerprint(Y_live, W_live) != fp:
            raise ValueError(
                f"session snapshot {path!r} is corrupt: the stored live "
                "panel does not match its content fingerprint")
        b = TorchBackend() if backend is None else backend
        model = DynamicFactorModel(
            n_factors=int(meta["model_n_factors"]),
            dynamics=str(meta["model_dynamics"]),
            standardize=bool(meta["model_standardize"]),
            estimate_init=bool(meta["model_estimate_init"]))
        T_live, N = Y_live.shape
        opts = FusedOptions(horizon=int(meta["horizon"]),
                            di=bool(meta["di"]))
        ring_mode = bool(meta["ring"]) if ring is None else bool(ring)
        capacity = (int(meta["capacity"]) if capacity is None
                    else int(capacity))
        if capacity < opts.horizon + 3:
            raise ValueError(
                f"capacity={capacity} < horizon + 3 = {opts.horizon + 3}: "
                "the restored session could not anchor its forecast "
                "regressions")
        if ring_mode and int(meta["max_update_rows"]) > capacity:
            raise ValueError(
                f"ring mode needs max_update_rows <= capacity; the "
                f"snapshot was taken with max_update_rows="
                f"{int(meta['max_update_rows'])} > capacity={capacity}")
        if T_live > capacity:
            # Trailing-window restore: only ring mode may drop rows.
            if not ring_mode:
                raise ValueError(
                    f"capacity={capacity} is smaller than the stored "
                    f"live panel (T={T_live}): restoring would drop the "
                    "oldest rows, which only ring mode allows — pass "
                    "ring=True (trailing-window semantics) or a "
                    "capacity >= the stored length")
            Y_live = Y_live[T_live - capacity:]
            W_live = W_live[T_live - capacity:]
        engine = _resolve_serve_engine(
            b, meta["filter"], filter, meta["rank"] if rank is None else rank,
            N)
        self = cls.__new__(cls)
        self._setup(b, model, params,
                    Standardizer(mean=mean, scale=scale) if mean.size
                    else None, Y_live, W_live, engine, opts,
                    capacity=capacity,
                    ring=ring_mode, t_total=int(meta["t_total"]),
                    max_update_rows=int(meta["max_update_rows"]),
                    max_iters=int(meta["max_iters"]), tol=float(meta["tol"]),
                    n_queries=int(meta["n_queries"]))
        return self

    def close(self):
        """Release the device buffers; further updates raise."""
        self._Ybuf = self._Wbuf = self._p = None
        self._Yhost = self._Whost = None
        self._closed = True

    def __repr__(self):
        state = "closed" if self._closed else (
            f"t={self._t}/{self._capacity}"
            + (f", ring (evicted {self.n_evicted})" if self._ring else "")
            + f", {self._n_queries} queries")
        return (f"NowcastSession({self._sid}, N={self._N}, "
                f"filter={self._cfg.filter}, {state})")


@contextlib.contextmanager
def _sync_debug_error():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def open_session(res=None, Y=None, mask=None, *, snapshot=None,
                 **kwargs) -> NowcastSession:
    """Open a streaming ``NowcastSession`` from a fitted model.

    res  : the ``FitResult`` of a ``DynamicFactorModel`` fit of ``Y``.
    Y    : (T, N) panel the model was fitted on (original units; NaNs =
           missing), ``mask`` as in ``fit``.
    capacity        : padded time budget (default 2*T).
    max_update_rows : largest per-update row count (default 8).
    max_iters / tol : warm EM budget per query (default 5 / 1e-6).
    horizon / di    : forecast steps and diffusion-index toggle.
    ring            : True turns the panel into a ring buffer: updates
                      past capacity evict the oldest rows (K13) instead
                      of raising.
    filter / rank   : serving engine ("dense", "info", "pit", "pit_qr",
                      "lowrank") and lowrank conditioning rank; default
                      inherits the fit's resolved ``FitResult.filter``
                      (rank from the backend).
    backend         : a ``TorchBackend`` (default ``TorchBackend()``, CUDA).
    robust          : None/False only (the guard is Queue 1 item 5).
    snapshot        : path written by ``session.snapshot(path)`` (this
                      package's or the JAX package's): restores that
                      session instead (pass no res/Y/mask).
    """
    if snapshot is not None:
        if res is not None or Y is not None or mask is not None:
            raise ValueError(
                "open_session(snapshot=...) restores a saved session: "
                "res/Y/mask come from the snapshot and cannot be passed")
        return NowcastSession.restore(snapshot, **kwargs)
    if res is None or Y is None:
        raise TypeError("open_session needs (res, Y) — or snapshot= to "
                        "restore a saved session")
    return NowcastSession(res, Y, mask=mask, **kwargs)
