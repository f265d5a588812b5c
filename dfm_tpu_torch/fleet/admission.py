"""Admission control: assign fleet tenants to capacity classes.

A copy of ``dfm_tpu.fleet.admission``.  A capacity class is one bucket
shape: every member tenant's panel is resident padded to the class dims,
and one batched tick per class answers all of its queued queries.  More
classes means tighter padding (less per-tick padded work) but one more
tick per round; ``sched.buckets.plan_capacity_classes`` runs the
calibrated cost-model DP over exactly that trade.

Tenants whose models differ in estimation flags (estimate_A/Q/init) or
engine cannot share a bucket, so admission first partitions by config and
plans classes within each group, deterministically: groups are visited in
first-tenant submit order, and the DP itself is deterministic given the
profile registry.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..obs.cost import em_iter_work, fit_cost_model
from ..sched.buckets import lane_rent_bytes, plan_capacity_classes

__all__ = ["ClassAssignment", "choose_engine", "device_class",
           "plan_admission", "fleet_pad_waste", "plan_residency",
           "readmission_cost_s"]


def device_class(device) -> str:
    """The cost model's device class of a torch device ("gpu" for CUDA,
    "cpu"), as the JAX package's ``obs.store.device_kind`` files its
    runs: a fleet is priced from its own device's profiles."""
    dev = torch.device(device)
    return "gpu" if dev.type == "cuda" else dev.type


@dataclasses.dataclass(frozen=True)
class ClassAssignment:
    """One planned capacity class: padded ``dims`` = (T_cap, N_max, k_max)
    and the submit-order tenant indices assigned to it."""

    dims: Tuple[int, int, int]
    members: Tuple[int, ...]


def _load_model(runs: Optional[str], device: Optional[str]):
    from ..obs.store import RunStore, runs_dir
    d = runs_dir(runs)
    profiles = []
    if d is not None:
        profiles = [r for r in RunStore(d).load()
                    if r.get("kind") == "profile"]
    return fit_cost_model(profiles, device=device)


def plan_admission(shapes: Sequence[Tuple[int, int, int]],
                   iters: Sequence[int],
                   cfg_keys: Optional[Sequence[tuple]] = None, *,
                   max_classes: int = 3, model=None,
                   runs: Optional[str] = None,
                   device: Optional[str] = None) -> List[ClassAssignment]:
    """Plan capacity classes for tenants with per-tenant resident shapes
    ``[(T_capacity, N, k), ...]`` and per-tick EM budgets ``iters``.

    ``cfg_keys`` (optional, one hashable per tenant) force tenants with
    different keys into different classes; ``max_classes`` bounds the
    TOTAL class count (each config group gets at least one).  ``model``
    overrides the cost model (default: calibrate from the profile
    registry, device priors when empty — same resolution as
    ``obs.advise``); ``device`` its device class (None: the class of the
    registry's last profile).  Deterministic given a fixed registry.
    """
    B = len(shapes)
    if B == 0:
        return []
    if len(iters) != B:
        raise ValueError("iters must match shapes length")
    keys = [()] * B if cfg_keys is None else list(cfg_keys)
    if len(keys) != B:
        raise ValueError("cfg_keys must match shapes length")
    m = model if model is not None else _load_model(runs, device)
    groups: List[Tuple[tuple, List[int]]] = []
    for i, key in enumerate(keys):
        for gk, members in groups:
            if gk == key:
                members.append(i)
                break
        else:
            groups.append((key, [i]))
    if max_classes < len(groups):
        raise ValueError(
            f"max_classes={max_classes} but the fleet has {len(groups)} "
            "incompatible model configs (each needs its own class)")
    # Budget split: every group gets one class; the extras round-robin
    # over groups largest-first (deterministic, and generous where the
    # padding waste can actually accrue).
    extra = max_classes - len(groups)
    alloc = [1] * len(groups)
    order = sorted(range(len(groups)), key=lambda gi: -len(groups[gi][1]))
    gi = 0
    while extra > 0 and any(alloc[j] < len(groups[j][1]) for j in order):
        j = order[gi % len(order)]
        if alloc[j] < len(groups[j][1]):
            alloc[j] += 1
            extra -= 1
        gi += 1
    out: List[ClassAssignment] = []
    for (gk, members), mc in zip(groups, alloc):
        plan = plan_capacity_classes(
            [shapes[i] for i in members], [iters[i] for i in members],
            max_classes=mc, model=m)
        for b in plan.buckets:
            out.append(ClassAssignment(
                dims=b.dims,
                members=tuple(members[j] for j in b.jobs)))
    return out


def choose_engine(dims: Tuple[int, int, int], iters: int, *,
                  rank: int = 0, model=None, runs: Optional[str] = None,
                  device: Optional[str] = None) -> str:
    """Pick the serving engine for one capacity class (``filter="auto"``).

    Compares the calibrated per-iteration cost of the info-form scan
    against ``pit_qr`` and ``lowrank`` at the class's padded dims, under
    the evidence gate: an engine whose residual scale was never
    measured (``pit_qr_calibrated``/``lowrank_calibrated`` False) is NOT
    a candidate — raw structural priors never make an "auto" fleet
    compile an engine nobody timed.  With an empty registry every gate is
    closed and the choice is "info" (the pre-routing fleet).
    Deterministic given a fixed profile registry; ties keep "info".
    """
    m = model if model is not None else _load_model(runs, device)
    T, N, k = int(dims[0]), int(dims[1]), int(dims[2])
    best, best_s = "info", m.iter_s(N, T, k, "seq")
    if getattr(m, "pit_qr_calibrated", False):
        s = m.iter_s(N, T, k, "pit_qr")
        if s < best_s:
            best, best_s = "pit_qr", s
    if getattr(m, "lowrank_calibrated", False) and k > max(1, int(rank)):
        s = m.iter_s(N, T, k, "lowrank")
        if s < best_s:
            best, best_s = "lowrank", s
    return best


def fleet_pad_waste(shapes: Sequence[Tuple[int, int, int]],
                    iters: Sequence[int],
                    classes: Sequence[ClassAssignment]) -> float:
    """Aggregate padded-flop waste of an admission plan: 1 - true/padded
    EM flops over all tenants at their per-tick budgets (the bench's
    ``fleet_pad_waste_frac``)."""
    true_fl = padded_fl = 0.0
    for ca in classes:
        bT, bN, bk = ca.dims
        for i in ca.members:
            T, N, k = shapes[i]
            true_fl += em_iter_work(N, T, k)[0] * iters[i]
            padded_fl += em_iter_work(bN, bT, bk)[0] * iters[i]
    return 1.0 - true_fl / padded_fl if padded_fl > 0 else 0.0


def readmission_cost_s(dims: Tuple[int, int, int], *, r_max: int = 0,
                       model=None, runs: Optional[str] = None,
                       device: Optional[str] = None) -> float:
    """Predicted wall of paging one warm tenant back into a hot lane of a
    class with padded ``dims``: a d2h of the bucket params (the shadow
    refresh that keeps bucket-mates exact), the full-lane h2d re-upload,
    and one dispatch floor — priced with the SAME calibrated coefficients
    ``obs.advise`` ranks plans with (``per_byte_s``/``dispatch_floor_s``;
    ``sched.buckets.lane_rent_bytes`` supplies the byte count).
    Deterministic given a fixed profile registry."""
    m = model if model is not None else _load_model(runs, device)
    rent = lane_rent_bytes(dims, r_max)
    return float(m.dispatch_floor_s + 2.0 * rent * m.per_byte_s)


def plan_residency(classes: Sequence[ClassAssignment],
                   resident: Optional[int], *, r_max: int = 0,
                   model=None, runs: Optional[str] = None,
                   device: Optional[str] = None) -> List[int]:
    """Split a fleet-wide resident-lane budget over capacity classes.

    Returns per-class hot-lane counts.  Every class keeps >= 1 lane (a
    bucket with zero lanes has no program to serve its members), then
    the remaining budget goes greedily to the class where a hot lane
    AVOIDS the most predicted paging cost: ``readmission_cost_s(dims) *
    unhoused members`` — the calibrated cost model's re-admission price
    against the HBM rent the lane charges.  ``resident=None`` (no cap)
    makes every member hot.  Deterministic: ties break on class index.
    """
    n_members = [len(ca.members) for ca in classes]
    if resident is None:
        return n_members
    m = model if model is not None else _load_model(runs, device)
    want = max(len(classes), int(resident))
    lanes = [1 if n else 0 for n in n_members]
    budget = want - sum(lanes)
    costs = [readmission_cost_s(ca.dims, r_max=r_max, model=m)
             for ca in classes]
    while budget > 0:
        best, best_gain = -1, 0.0
        for ci, ca in enumerate(classes):
            unhoused = n_members[ci] - lanes[ci]
            gain = costs[ci] * unhoused
            if unhoused > 0 and gain > best_gain:
                best, best_gain = ci, gain
        if best < 0:
            break
        lanes[best] += 1
        budget -= 1
    return lanes
