"""Device-resident fleet state: tenant slots packed into bucket buffers.

The PyTorch twin of ``dfm_tpu.fleet.buffers``.  A ``TenantSlot`` is the
host record of one tenant: its frozen standardizer, model, live length and
budgets.  A ``FleetBucket`` packs the slots of one capacity class into
(B, T_cap, N_max) device panel buffers and one stacked params set, with
the inert-padding seams of ``estim.batched`` (``pad_panel_to_t`` /
``pad_panel_to_n`` exact-zero panels with a zero mask,
``pad_params_to_k`` / ``pad_params_to_n`` inert factors and series), so
lane b of the bucket is tenant b's lone session buffer under the masked
serving twins.

Host shadows (f64 NumPy panels, standardized) mirror the device panel:
they are the source the device panel is re-uploaded from when a tick
raises after kernel K13b edited it in place.  Each lane's shadow is a
ring: physical row ``(h0[lane] + t) % T_cap`` holds live row t, so
mirroring a ring eviction moves the lane's origin and copies no row.  The
device buffers are always copies of the shadows, never views (the host
mirror of each tick edits the shadows).

Not ported yet (ROADMAP Queue 1 item 8, the fleet's next slice): the
warm/cold tiers (a slot's parked shadows, ``demote`` / ``admit``) and the
original-units live panel a slot keeps for snapshots and quarantine.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..estim.batched import (pad_panel_to_n, pad_panel_to_t, pad_params_to_k,
                             pad_params_to_n, stack_params, unstack_params)
from ..estim.em import EMConfig, noise_floor_for
from ..utils.data import build_mask

__all__ = ["TenantSlot", "FleetBucket"]


@dataclasses.dataclass
class TenantSlot:
    """Host record of one fleet tenant (see the module docstring)."""

    name: str
    lane: int                  # index along the bucket's batch axis
    N: int
    k: int
    t: int                     # live panel length (rows so far)
    capacity: int              # this tenant's own row budget (<= T_cap)
    max_iters: int
    tol: float
    std: object                # frozen Standardizer (or None)
    model: object              # DynamicFactorModel
    n_queries: int = 0
    t_total: int = 0           # stream position: rows ever held
    last_band: Optional[tuple] = None  # (y_fore, y_sd) of previous query
    tier: str = "hot"          # always a device lane here

    @property
    def n_evicted(self) -> int:
        """Rows retired by the ring buffer so far (0 outside ring mode)."""
        return self.t_total - self.t


class FleetBucket:
    """One capacity class: B tenants resident in batched device buffers.

    ``entries`` is a list of ``(name, res, Y, mask, capacity, max_iters,
    tol)`` tuples; ``dims = (T_cap, N_max, k_max)`` the class shape every
    member is padded to; ``filter`` the bucket's engine ("info",
    "pit_qr" or "lowrank") and ``rank`` its lowrank rank (<= 0: auto, at
    k_max).  ``lane_of`` maps a lane to its tenant.
    """

    def __init__(self, entries, dims, *, r_max: int, backend, opts,
                 filter: str = "info", rank: int = 0):
        T_cap, N_max, k_max = dims
        self.dims = tuple(int(d) for d in dims)
        self.r_max = int(r_max)
        self.opts = opts
        self.backend = backend
        self.dt, self.dev = backend.dtype, backend.device
        self.slots: List[TenantSlot] = []
        Yh, Wh, ps = [], [], []
        est = None
        for i, (name, res, Y, mask, cap, m_it, tol) in enumerate(entries):
            Y = np.asarray(Y, dtype=np.float64)
            T0, N = Y.shape
            W = build_mask(Y, mask)
            std = res.standardizer
            Yz = std.transform(Y) if std is not None else Y
            Yz = np.where(W > 0, np.nan_to_num(Yz), 0.0)
            Yh.append(pad_panel_to_t(pad_panel_to_n(Yz, N_max), T_cap))
            Wh.append(pad_panel_to_t(pad_panel_to_n(W, N_max), T_cap))
            ps.append(pad_params_to_n(pad_params_to_k(res.params, k_max),
                                      N_max))
            m = res.model
            e = (m.estimate_A, m.estimate_Q, m.estimate_init)
            if est is None:
                est = e
            elif e != est:   # admission groups by config; belt-and-braces
                raise ValueError(
                    f"tenant {name!r} has estimation flags {e} but the "
                    f"bucket was planned for {est}")
            self.slots.append(TenantSlot(
                name=name, lane=i, N=N, k=res.params.Lam.shape[1], t=T0,
                capacity=int(cap), max_iters=int(m_it), tol=float(tol),
                std=std, model=m, t_total=T0))
        self.B = len(self.slots)
        self.lane_of = {s.lane: s for s in self.slots}
        self.Yhost = np.stack(Yh).astype(np.float64)
        self.Whost = np.stack(Wh).astype(np.float64)
        self.h0 = np.zeros(self.B, np.int64)     # ring origin of each lane
        # One EM length per bucket; per-lane budgets ride the iteration
        # cap vector below it.
        self.max_iters = max(s.max_iters for s in self.slots)
        self.cfg = EMConfig(estimate_A=est[0], estimate_Q=est[1],
                            estimate_init=est[2], filter=str(filter),
                            rank=int(rank))
        self.upload_panel()
        self.p = stack_params(ps, dtype=self.dt, device=self.dev)
        self.n_ticks = 0

    def floor_for(self, slot: TenantSlot, t_new: int) -> float:
        """Per-tenant absolute loglik noise floor at the TRUE live size:
        the float the same tenant's lone session computes."""
        return float(noise_floor_for(self.dt, t_new * slot.N,
                                     mult=self.cfg.noise_floor_mult))

    # -- host shadows ----------------------------------------------------
    def host_rows(self, lane: int, lo: int, hi: int) -> np.ndarray:
        """Physical rows of lane ``lane``'s shadows holding live rows
        [lo, hi)."""
        return (self.h0[lane] + np.arange(lo, hi)) % self.dims[0]

    def mirror(self, lane: int, n_evict: int, t_mid: int, rz, W_rows):
        """The tick's eviction and append on lane ``lane``'s shadows, as
        K13b made them on the device: the eviction moves the origin, the
        rows it wraps to the tail are zeroed, then the standardized rows
        ``rz`` (n, N) and their mask land at live rows t_mid.."""
        T_cap = self.dims[0]
        if n_evict:
            self.h0[lane] = (self.h0[lane] + n_evict) % T_cap
            tail = self.host_rows(lane, T_cap - n_evict, T_cap)
            self.Yhost[lane, tail] = 0.0
            self.Whost[lane, tail] = 0.0
        n, N = rz.shape
        new = self.host_rows(lane, t_mid, t_mid + n)
        self.Yhost[lane, new, :N] = rz
        self.Whost[lane, new, :N] = W_rows

    def live_host(self, lane: int):
        """Lane ``lane``'s shadows (Y, W) in live-row order, (T_cap,
        N_max) copies."""
        rows = self.host_rows(lane, 0, self.dims[0])
        return self.Yhost[lane, rows], self.Whost[lane, rows]

    def upload_panel(self):
        """The device panel from the host shadows (live-row order), in one
        upload each; never a view of the shadows."""
        Y = np.empty_like(self.Yhost)
        W = np.empty_like(self.Whost)
        for lane in range(self.B):
            Y[lane], W[lane] = self.live_host(lane)
        self.Ybuf = torch.tensor(Y, dtype=self.dt, device=self.dev)
        self.Wbuf = torch.tensor(W, dtype=self.dt, device=self.dev)

    # -- device state ----------------------------------------------------
    def rebind(self, out):
        """Adopt a tick's outputs as the resident state (K13b edited the
        panel buffers in place)."""
        self.Ybuf, self.Wbuf = out["Ybuf"], out["Wbuf"]
        self.p = out["p"]

    def params_host(self, out_p=None):
        """Per-lane padded NumPy f64 params of the stacked params ``out_p``
        (a tick's fresh ones), by default the resident ones (one read)."""
        return unstack_params(out_p if out_p is not None else self.p)

    def __repr__(self):
        T, N, k = self.dims
        return (f"FleetBucket(B={self.B}, T_cap={T}, N_max={N}, "
                f"k_max={k}, filter={self.cfg.filter})")
