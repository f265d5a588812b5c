"""Fleet driver: batched session multiplexing over shape-bucketed tenants.

The PyTorch twin of ``dfm_tpu.fleet.driver``.  ``open_fleet(results,
panels)`` packs B fitted tenants into capacity classes
(``admission.plan_admission``, the calibrated cost-model DP) and keeps
every class device-resident in one ``FleetBucket``; ``submit`` enqueues a
tenant's ragged row update (host validation only: a rejected submit
touches nothing) and ``drain`` serves the queue in TICKS: one batched
program per bucket per tick (``serve.batched._fleet_core``) answers every
member's next query (kernel K13b's ring eviction and append, per-tenant
warm EM with independent freezes, the smooth, nowcast, bands and
forecasts), followed by ONE blocking device->host read of every lane's
outputs (``estim.fused.read_packed``).  ``SessionFleet.check_sync = True``
runs each tick's device part under
``torch.cuda.set_sync_debug_mode("error")``, so a hidden synchronization
raises.

Lane b of a tick answers what the same tenant's lone ``NowcastSession``
would at the same budget; tenants with no query this tick are frozen bit
for bit.  ``ring=True`` rolls a tenant's oldest rows off once its capacity
fills.  Each lane's live length, row count and eviction count are known
on the host, which builds them; the kernels get device copies.  If a tick
raises after K13b edited the device panel in place, the bucket's panel is
re-uploaded from the host shadows before the error propagates.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``robust=`` other than None/False and with it quarantine (Queue 1
item 5; without faults the JAX fleet at ``robust=False`` gives the same
numbers); request tracing and the live plane (``trace=``,
``accounting()``; item 13); the warm/cold tiers and the fleet manifest
(``resident=``, ``evict``, ``admit``, ``snapshot_all``, ``restore_fleet``,
``read_manifest``; item 8, the fleet's next slice); the sharded tick
(item 12).

Admission and the "auto" engine price the fleet with the cost model of
the backend's own device class ("gpu" for CUDA, "cpu"): profiles of
another device in the registry do not plan this fleet.
"""

from __future__ import annotations

import contextlib
import itertools
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..estim.fused import read_packed
from ..ops.precision import highest_precision
from ..serve.batched import (CONVERGED, DIVERGED, FleetOptions, _fleet_core,
                             _not_ported)
from ..serve.session import _Z90, SessionUpdate, _sync_debug_error
from ..utils.data import build_mask
from .admission import (choose_engine, device_class, fleet_pad_waste,
                        plan_admission)
from .buffers import FleetBucket

__all__ = ["SessionFleet", "open_fleet", "restore_fleet", "read_manifest"]

# Engines a fleet bucket routes; "auto" defers to the cost model per class
# (evidence-gated: an unprofiled engine is never chosen).
_FLEET_FILTERS = ("info", "pit_qr", "lowrank")

_FLEET_IDS = itertools.count(1)

# The outputs of a tick that cross to the host, in its one read.
_HOST_KEYS = ("status", "n_iters", "good_it", "lls", "nowcast", "nowcast_sd",
              "f_fore", "y_fore", "y_sd", "di", "x_sm", "P_sm")


_TIERS = "Queue 1 item 8 (the fleet's warm/cold tiers and manifest)"


class _Query:
    """One queued tenant update (host units, validated at submit)."""

    __slots__ = ("tenant", "rows", "W_rows", "rz", "n_new", "t_submit")

    def __init__(self, tenant, rows, W_rows, rz, n_new):
        self.tenant = tenant
        self.rows = rows            # (n, N) original units, NaNs kept
        self.W_rows = W_rows        # (n, N) {0,1}
        self.rz = rz                # (n, N) standardized, zero-filled
        self.n_new = n_new
        self.t_submit = time.perf_counter()


def _per_tenant(value, B, name, cast):
    """Broadcast a scalar knob or validate a per-tenant sequence."""
    if value is None or np.isscalar(value):
        return [value] * B
    vals = [cast(x) for x in value]
    if len(vals) != B:
        raise ValueError(f"{name} must be a scalar or one value per "
                         f"tenant; got {len(vals)} for {B} tenants")
    return vals


def _resolve_backend(backend):
    from ..api import TorchBackend
    if backend is None:
        return TorchBackend()
    if isinstance(backend, TorchBackend):
        return backend
    if backend == "sharded":
        raise _not_ported("open_fleet(backend='sharded')", "Queue 1 item 12")
    raise ValueError(f"open_fleet: backend must be a TorchBackend or None, "
                     f"got {backend!r}")


class SessionFleet:
    """Batched multi-tenant serving fleet (see the module docstring).

    Open with :func:`open_fleet`; then ``submit(tenant, rows)`` enqueues
    and ``drain()`` serves the whole queue, returning per-tenant
    ``SessionUpdate`` lists in submit order.
    """

    # True: run each tick's device work under
    # torch.cuda.set_sync_debug_mode("error") (CUDA fleets).
    check_sync = False

    def __init__(self, results, panels, masks=None, *,
                 tenants: Optional[Sequence[str]] = None,
                 capacity=None, max_update_rows: int = 8, max_iters=5,
                 tol=1e-6, horizon: Optional[int] = None,
                 di: Optional[bool] = None, ring: bool = False,
                 filter=None, rank=None,
                 resident: Optional[int] = None, backend=None,
                 robust=None, max_classes: int = 3,
                 runs: Optional[str] = None):
        from ..api import DynamicFactorModel, FitResult
        results = list(results)
        panels = list(panels)
        B = len(results)
        if B == 0:
            raise ValueError("open_fleet needs at least one tenant")
        if len(panels) != B:
            raise ValueError(f"{B} results but {len(panels)} panels")
        masks = [None] * B if masks is None else list(masks)
        if len(masks) != B:
            raise ValueError(f"{B} results but {len(masks)} masks")
        names = ([f"t{i}" for i in range(B)] if tenants is None
                 else [str(t) for t in tenants])
        if len(names) != B or len(set(names)) != B:
            raise ValueError("tenants must be one UNIQUE name per tenant")
        if robust not in (None, False):
            raise _not_ported("open_fleet(robust=) (the tick guard and "
                              "quarantine)", "Queue 1 item 5")
        if resident is not None:
            raise _not_ported("open_fleet(resident=)", _TIERS)
        b = _resolve_backend(backend)
        self._opts = FleetOptions(
            horizon=1 if horizon is None else max(1, int(horizon)),
            di=True if di is None else bool(di))
        caps = _per_tenant(capacity, B, "capacity", int)
        m_its = _per_tenant(max_iters, B, "max_iters", int)
        tols = _per_tenant(tol, B, "tol", float)
        filts = _per_tenant(filter, B, "filter", str)
        ranks = _per_tenant(rank, B, "rank", int)
        shapes, cfg_keys, entries, engines = [], [], [], []
        for i, (res, Y) in enumerate(zip(results, panels)):
            if not isinstance(res, FitResult):
                raise TypeError(
                    f"tenant {names[i]!r}: open_fleet needs FitResults; "
                    f"got {type(res).__name__}")
            if not isinstance(res.model, DynamicFactorModel):
                raise TypeError(
                    f"tenant {names[i]!r}: fleets support "
                    f"DynamicFactorModel fits only; got "
                    f"{type(res.model).__name__}")
            Y = np.asarray(Y, dtype=np.float64)
            if Y.ndim != 2:
                raise ValueError(
                    f"tenant {names[i]!r}: Y must be (T, N); got shape "
                    f"{Y.shape}")
            T0, N = Y.shape
            Lam = np.asarray(res.params.Lam)
            if Lam.shape[0] != N:
                raise ValueError(
                    f"tenant {names[i]!r}: params are for "
                    f"N={Lam.shape[0]} series but the panel has N={N}")
            if T0 < self._opts.horizon + 3:
                raise ValueError(
                    f"tenant {names[i]!r}: needs T >= horizon + 3 = "
                    f"{self._opts.horizon + 3} live rows; got T={T0}")
            cap = 2 * T0 if caps[i] is None else int(caps[i])
            if cap < T0:
                raise ValueError(
                    f"tenant {names[i]!r}: capacity={cap} < panel "
                    f"length T={T0}")
            if ring and max_update_rows > cap:
                raise ValueError(
                    f"tenant {names[i]!r}: ring mode needs "
                    f"max_update_rows <= capacity so an update never "
                    f"evicts more rows than it appends; got "
                    f"max_update_rows={max_update_rows} > capacity={cap}")
            m_it = max(1, 5 if m_its[i] is None else int(m_its[i]))
            tl = 1e-6 if tols[i] is None else float(tols[i])
            k = Lam.shape[1]
            shapes.append((cap, N, k))
            m = res.model
            # An explicit filter= wins ("auto" defers to the cost model
            # per class); the default inherits the fit's engine when the
            # fleet routes it, else the info-form twins.
            f_i = filts[i]
            if f_i is None:
                rf = getattr(res, "filter", None)
                f_i = rf if rf in ("pit_qr", "lowrank") else "info"
            elif f_i not in _FLEET_FILTERS + ("auto",):
                raise ValueError(
                    f"tenant {names[i]!r}: unknown fleet filter {f_i!r}; "
                    f"buckets route {_FLEET_FILTERS} (or 'auto' for the "
                    "calibrated cost-model choice per class)")
            r_i = int(0 if ranks[i] is None else ranks[i])
            r_i = r_i if f_i in ("lowrank", "auto") else 0
            engines.append((f_i, r_i))
            # The engine joins the admission key: buckets are engine-
            # homogeneous.
            cfg_keys.append((m.estimate_A, m.estimate_Q, m.estimate_init,
                             f_i, r_i))
            entries.append((names[i], res, Y, masks[i], cap, m_it, tl))
        iters = [e[5] for e in entries]
        device = device_class(b.device)
        classes = plan_admission(shapes, iters, cfg_keys,
                                 max_classes=max_classes, runs=runs,
                                 device=device)
        self.pad_waste_frac = fleet_pad_waste(shapes, iters, classes)
        self._r_max = max(1, int(max_update_rows))
        self._ring = bool(ring)
        self._backend = b
        self._buckets: List[FleetBucket] = []
        self._slot_of = {}           # tenant -> (bucket, slot)
        for ca in classes:
            eng, rk = engines[ca.members[0]]
            if eng == "auto":
                eng = choose_engine(ca.dims, max(iters[i] for i in ca.members),
                                    rank=rk, runs=runs, device=device)
            bk = FleetBucket([entries[i] for i in ca.members], ca.dims,
                             r_max=self._r_max, backend=b, opts=self._opts,
                             filter=eng, rank=rk)
            self._buckets.append(bk)
            for s in bk.slots:
                self._slot_of[s.name] = (bk, s)
        self._fid = f"f{next(_FLEET_IDS)}"
        self._pending: List[_Query] = []
        self._closed = False
        self._n_ticks = 0
        self._n_queries = 0

    # -- introspection -------------------------------------------------
    @property
    def fleet_id(self) -> str:
        return self._fid

    @property
    def tenants(self) -> List[str]:
        return list(self._slot_of)

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    @property
    def classes(self) -> List[dict]:
        """The admission plan: padded dims, engine and members of each
        capacity class."""
        return [{"dims": {"T": bk.dims[0], "N": bk.dims[1],
                          "k": bk.dims[2]},
                 "filter": bk.cfg.filter, "rank": bk.cfg.rank,
                 "tenants": [s.name for s in bk.slots]}
                for bk in self._buckets]

    @property
    def pending(self) -> int:
        return len(self._pending)

    def tenant_length(self, tenant: str) -> int:
        """Live panel length of one tenant (accepted rows only)."""
        return self._slot_of[tenant][1].t

    @property
    def ring(self) -> bool:
        """True if tenants evict their oldest rows past capacity."""
        return self._ring

    @property
    def resident_lanes(self) -> int:
        """Device lanes the fleet holds (every tenant is resident)."""
        return sum(bk.B for bk in self._buckets)

    def tier(self, tenant: str) -> str:
        """Residency tier of a tenant: always "hot" (a device lane)."""
        return self._slot_of[tenant][1].tier

    def quarantined(self) -> List[str]:
        """Tenants evicted to lone sessions: none without the guard."""
        return []

    def accounting(self) -> dict:
        raise _not_ported("SessionFleet.accounting() (the live plane)",
                          "Queue 1 item 13")

    def evict(self, tenant: str, tier: str = "warm", path=None) -> str:
        raise _not_ported("SessionFleet.evict", _TIERS)

    def admit(self, tenant: str) -> None:
        raise _not_ported("SessionFleet.admit", _TIERS)

    def snapshot_all(self, dir_path: str, journal_seq=None) -> str:
        raise _not_ported("SessionFleet.snapshot_all", _TIERS)

    def _check_open(self):
        if self._closed:
            raise RuntimeError("fleet is closed")

    # -- the queue -----------------------------------------------------
    def submit(self, tenant: str, rows=None, mask=None, trace=None) -> int:
        """Enqueue one tenant update ((n, N) or (N,) original-units rows,
        NaN = missing; ``rows=None`` queues a pure re-forecast: warm EM,
        smooth and forecast with no append).  Every check runs here, on
        the host, against the PROJECTED live length (rows already queued
        count); a rejected submit touches nothing.  Returns the queue
        depth after the submit."""
        self._check_open()
        if trace is not None:
            raise _not_ported("submit(trace=) (request tracing)",
                              "Queue 1 item 13")
        if tenant not in self._slot_of:
            raise KeyError(f"unknown tenant {tenant!r} (fleet has "
                           f"{sorted(self._slot_of)})")
        _, slot = self._slot_of[tenant]
        if rows is None:
            if mask is not None:
                raise ValueError("mask requires rows")
            r = np.zeros((0, slot.N))
            W_rows = np.zeros((0, slot.N))
            rz = r
        else:
            r = np.asarray(rows, dtype=np.float64)
            if r.ndim == 1:
                r = r[None, :]
            if r.ndim != 2 or r.shape[1] != slot.N:
                raise ValueError(
                    f"tenant {tenant!r}: rows must be (n, {slot.N}) or "
                    f"({slot.N},); got shape {np.asarray(rows).shape}")
            if r.shape[0] > self._r_max:
                raise ValueError(
                    f"tenant {tenant!r}: update has {r.shape[0]} rows "
                    f"but the fleet was opened with max_update_rows="
                    f"{self._r_max}")
            W_rows = build_mask(r, mask)
            rz = slot.std.transform(r) if slot.std is not None else r
            rz = np.where(W_rows > 0, np.nan_to_num(rz), 0.0)
        queued = sum(q.n_new for q in self._pending if q.tenant == tenant)
        if (not self._ring
                and slot.t + queued + r.shape[0] > slot.capacity):
            raise ValueError(
                f"tenant {tenant!r}: capacity overflow — holds {slot.t} "
                f"rows (+{queued} queued) of {slot.capacity} and cannot "
                f"take {r.shape[0]} more; open the fleet with ring=True "
                "to evict the oldest rows in place (unbounded streams "
                "at constant memory)")
        self._pending.append(_Query(tenant, r, W_rows, rz, r.shape[0]))
        return len(self._pending)

    def drain(self, *, on_tick: Optional[Callable] = None
              ) -> Dict[str, List[SessionUpdate]]:
        """Serve the whole queue: repeated tick rounds (one batched tick
        per bucket with work, each answering every member's next query,
        FIFO) until it is empty.  Returns per-tenant ``SessionUpdate``
        lists in submit order.  ``on_tick`` is called with the fleet after
        each round, between ticks."""
        self._check_open()
        out: Dict[str, List[SessionUpdate]] = {}
        while self._pending:
            picks: Dict[int, Dict[int, _Query]] = {}
            for q in self._pending:
                bk, slot = self._slot_of[q.tenant]
                lanes = picks.setdefault(self._buckets.index(bk), {})
                lanes.setdefault(slot.lane, q)
            served = []
            for bi, lane_q in picks.items():
                for tenant, upd in self._tick(self._buckets[bi], lane_q):
                    out.setdefault(tenant, []).append(upd)
                served.extend(lane_q.values())
            self._pending = [q for q in self._pending if q not in served]
            if on_tick is not None:
                on_tick(self)
        return out

    # -- the tick ------------------------------------------------------
    def _tick(self, bucket: FleetBucket, lane_q: Dict[int, _Query]):
        """One batched tick answering every picked lane: the host
        vectors, their upload, the device part (``_fleet_core``) and the
        one read, then the host mirror and the per-lane answers."""
        T_cap, N_max, _ = bucket.dims
        B, r_max = bucket.B, bucket.r_max
        rows_b = np.zeros((B, r_max, N_max))
        rmask_b = np.zeros((B, r_max, N_max))
        n_new = np.zeros(B, np.int32)
        evictv = np.zeros(B, np.int32)
        t_cur = np.zeros(B, np.int32)
        tolv = np.zeros(B)
        floorv = np.zeros(B)
        capv = np.ones(B, np.int32)
        act = np.zeros(B, bool)
        for lane, slot in bucket.lane_of.items():
            t_cur[lane] = slot.t
            tolv[lane] = slot.tol
            capv[lane] = slot.max_iters
            floorv[lane] = bucket.floor_for(slot, slot.t)
        for lane, q in lane_q.items():
            slot = bucket.lane_of[lane]
            rows_b[lane, :q.n_new, :slot.N] = q.rz
            rmask_b[lane, :q.n_new, :slot.N] = q.W_rows
            n_new[lane] = q.n_new
            # Ring eviction: past capacity the oldest rows roll off
            # before the append (a non-ring submit already raised).
            evictv[lane] = max(0, slot.t + q.n_new - slot.capacity)
            act[lane] = True
            floorv[lane] = bucket.floor_for(
                slot, min(slot.t + q.n_new, slot.capacity))
        b = self._backend
        dev = bucket.dev
        t0 = time.perf_counter()
        # (1) upload, before the sync guard: a blocking host->device copy
        # is a synchronization too.
        rows_t, rmask_t = b.tensor(rows_b), b.tensor(rmask_b)
        ivec = {k: torch.as_tensor(v, device=dev) for k, v in
                (("n_new", n_new), ("n_evict", evictv), ("t_cur", t_cur),
                 ("iter_cap", capv), ("act", act))}
        tol_t = torch.as_tensor(tolv, dtype=torch.float64, device=dev)
        floor_t = torch.as_tensor(floorv, dtype=torch.float64, device=dev)
        try:
            with highest_precision(), self._sync_guard():       # (2)
                out = _fleet_core(
                    bucket.Ybuf, bucket.Wbuf, rows_t, rmask_t,
                    ivec["n_new"], ivec["n_evict"], ivec["t_cur"], bucket.p,
                    tol_t, floor_t, ivec["iter_cap"], ivec["act"],
                    bucket.cfg, bucket.max_iters, bucket.opts)
            host = self._read(out)                              # (3)
        except BaseException:
            # K13b may already have shifted or appended the device panel
            # in place; the host shadows still hold the pre-tick panel.
            bucket.upload_panel()
            raise
        wall = time.perf_counter() - t0
        bucket.rebind(out)
        bucket.n_ticks += 1
        self._n_ticks += 1
        results = []
        for lane, q in sorted(lane_q.items()):
            slot = bucket.lane_of[lane]
            e = int(evictv[lane])
            t_mid = slot.t - e
            t_new = t_mid + q.n_new
            bucket.mirror(lane, e, t_mid, q.rz, q.W_rows)
            slot.t = t_new
            slot.t_total += q.n_new
            slot.n_queries += 1
            self._n_queries += 1
            # Coverage: this query's observed new rows against the
            # PREVIOUS query's 90% band (original units, host only).
            cov = None
            if q.n_new and slot.last_band is not None:
                pf, ps = slot.last_band
                n_cmp = min(q.n_new, pf.shape[0])
                obs = q.W_rows[:n_cmp] > 0
                if obs.any():
                    err = np.abs(q.rows[:n_cmp] - pf[:n_cmp])
                    cov = float(np.mean((err <= _Z90 * ps[:n_cmp])[obs]))
            upd = self._lane_update(host, slot, t_new, wall)
            upd.coverage = cov
            slot.last_band = (upd.forecasts["y"], upd.forecast_sd)
            if int(host["status"][lane]) == DIVERGED:
                warnings.warn(
                    f"fleet tenant {slot.name!r} diverged after "
                    f"{int(host['good_it'][lane])} good iterations; "
                    "kept the rolled-back params", RuntimeWarning,
                    stacklevel=3)
            results.append((slot.name, upd))
        return results

    def _sync_guard(self):
        """``check_sync`` on a CUDA fleet: a context in which any
        device->host synchronization raises."""
        if not (self.check_sync and self._backend.device.type == "cuda"):
            return contextlib.nullcontext()
        return _sync_debug_error()

    def _read(self, out: dict) -> dict:
        """The tick's one blocking device->host read: every host-bound
        output of every lane, packed (``estim.fused.read_packed``)."""
        return read_packed({k: out[k] for k in _HOST_KEYS})

    def _lane_update(self, host, slot, t_new, wall) -> SessionUpdate:
        """Slice lane ``slot.lane`` out of the tick's host outputs and
        destandardize: the fleet's ``SessionUpdate`` for this tenant."""
        ln, N, k = slot.lane, slot.N, slot.k
        inv = slot.std.inverse if slot.std is not None else (lambda a: a)
        # Bands destandardize by the scale alone (the shift cancels).
        sd_inv = ((lambda s: s * slot.std.scale)
                  if slot.std is not None else (lambda s: s))
        n = min(int(host["n_iters"][ln]), slot.max_iters)
        di = host["di"]
        status = int(host["status"][ln])
        return SessionUpdate(
            nowcast=np.asarray(inv(host["nowcast"][ln][:N])),
            forecasts={
                "y": np.asarray(inv(host["y_fore"][ln][:, :N])),
                "f": host["f_fore"][ln][:, :k],
                "di": (np.asarray(inv(di[ln][:N]))
                       if di is not None else None)},
            logliks=host["lls"][ln][:n], n_iters=n,
            converged=status == CONVERGED, diverged=status == DIVERGED,
            factors=host["x_sm"][ln][:t_new, :k],
            factor_cov=host["P_sm"][ln][:t_new, :k, :k],
            t=t_new, wall_s=wall,
            nowcast_sd=np.asarray(sd_inv(host["nowcast_sd"][ln][:N])),
            forecast_sd=np.asarray(sd_inv(host["y_sd"][ln][:, :N])))

    # -- maintenance ---------------------------------------------------
    def swap_params(self, tenant: str, params) -> None:
        """Hot-swap one tenant's params (NumPy, at its true (N, k), in its
        frozen standardized scale): its lane of the stacked params is
        rewritten, its bucket-mates' lanes are untouched, and swapping
        bit-equal params is a bit-identical no-op."""
        from ..estim.batched import pad_params_to_k, pad_params_to_n
        self._check_open()
        if tenant not in self._slot_of:
            raise KeyError(f"unknown tenant {tenant!r} (fleet has "
                           f"{sorted(self._slot_of)})")
        bucket, slot = self._slot_of[tenant]
        Lam = np.asarray(params.Lam, np.float64)
        if tuple(Lam.shape) != (slot.N, slot.k):
            raise ValueError(
                f"swap_params: Lam has shape {tuple(Lam.shape)}, tenant "
                f"{tenant!r} serves (N, k)=({slot.N}, {slot.k})")
        _, N_b, k_b = bucket.dims
        p_pad = pad_params_to_n(pad_params_to_k(params, k_b), N_b)
        new = [torch.tensor(np.asarray(getattr(p_pad, f), np.float64),
                            dtype=bucket.dt, device=bucket.dev)
               for f in bucket.p._fields]
        leaves = []
        for leaf, val in zip(bucket.p, new):
            leaf = leaf.clone()
            leaf[slot.lane] = val
            leaves.append(leaf)
        bucket.p = type(bucket.p)(*leaves)

    # -- lifecycle -----------------------------------------------------
    def close(self):
        """Release the device buffers; further submits and drains
        raise."""
        for bk in self._buckets:
            bk.Ybuf = bk.Wbuf = bk.p = None
            bk.Yhost = bk.Whost = None
        self._pending = []
        self._closed = True

    def __repr__(self):
        state = "closed" if self._closed else (
            f"{len(self._slot_of)} tenants / {len(self._buckets)} "
            f"buckets, {self._n_queries} queries, "
            f"{len(self._pending)} pending")
        return f"SessionFleet({self._fid}, {state})"


def open_fleet(results, panels, masks=None, **kwargs) -> SessionFleet:
    """Open a batched serving fleet over B fitted tenants.

    results : per-tenant ``FitResult`` of a ``DynamicFactorModel`` fit.
    panels  : per-tenant (T, N) panels the models were fitted on
              (original units; NaNs = missing), ``masks`` as in ``fit``.
    tenants : unique names (default ``t0..t{B-1}``).
    capacity        : per-tenant row budget, scalar or sequence (default
                      2*T per tenant).
    max_update_rows : largest per-query row count (default 8).
    max_iters / tol : per-tenant warm EM budget per query (scalar or
                      sequence; default 5 / 1e-6).
    horizon / di    : forecast steps and diffusion-index toggle.
    ring            : ring-buffer panels: a submit past a tenant's
                      capacity evicts its oldest rows on the device
                      (K13b) instead of raising.
    filter / rank   : per-tenant serving engine ("info", "pit_qr",
                      "lowrank", or "auto" for the calibrated cost-model
                      choice per class, evidence-gated, priced for the
                      backend's device class) and lowrank rank (<= 0:
                      auto, min(k_max, 8) of the bucket); the default
                      inherits each fit's ``FitResult.filter`` when it
                      is "pit_qr" or "lowrank", else "info".
    backend         : a ``TorchBackend`` (default ``TorchBackend()``,
                      CUDA); "sharded" raises (item 12).
    max_classes     : capacity-class budget for admission control.
    runs            : profile registry of the admission cost model
                      (default: ``$DFM_RUNS`` or ``.dfm_runs``).
    robust / resident: None only (items 5 and 8).
    """
    return SessionFleet(results, panels, masks, **kwargs)


def read_manifest(dir_path: str) -> dict:
    """Load a ``snapshot_all`` manifest: not ported yet."""
    raise _not_ported("read_manifest", _TIERS)


def restore_fleet(dir_path: str, **kwargs) -> SessionFleet:
    """Rebuild a fleet from ``snapshot_all``: not ported yet."""
    raise _not_ported("restore_fleet", _TIERS)
