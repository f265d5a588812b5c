"""Cost-model-driven shape bucketing for mixed (T, N, k) job mixes.

The packing problem: every distinct padded shape is one more executable
(compile + a dispatch stream of its own), but every job padded into a
bucket pays the bucket's per-iteration cost, not its own.  The planner
balances the two with the calibrated ``obs.cost.CostModel``: sort jobs by
predicted per-iteration cost, then a small exact DP over CONTIGUOUS
partitions of that order picks at most ``max_buckets`` groups minimizing

    sum_buckets [ overhead + dispatches(cap) * dispatch_floor ]
      + sum_jobs iters_j * iter_s(bucket dims)

where a bucket's dims are the elementwise max over its members — so the
DP trades padded-flop waste (big bucket, few executables) against
dispatch/compile overhead (tight buckets, many executables) using the
same coefficients ``obs.advise`` ranks single-fit plans with.  Ties are
broken deterministically: fewer buckets first, then lexicographically
smallest cut positions.

A copy of ``dfm_tpu.sched.buckets``; everything here is pure: same
inputs -> same plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..obs.cost import CostModel, DEFAULT_COEFFS, em_iter_work

__all__ = ["Bucket", "BucketPlan", "lane_rent_bytes", "plan_buckets",
           "plan_capacity_classes"]


def lane_rent_bytes(dims: Tuple[int, int, int], r_max: int = 0,
                    bytes_per: int = 4) -> float:
    """HBM rent of ONE resident lane of a capacity class: the device
    bytes a tenant occupies just by being hot — padded panel + mask
    (T_cap x N each), the stacked params slice, and its share of the
    per-tick row staging.  This is the "rent" side of the paging
    economics: ``fleet.admission.readmission_cost_s`` prices the other
    side (what paging the tenant back in would cost), and the fleet's
    admission-pressure paging trades the two.  Pure arithmetic,
    deterministic; ``bytes_per`` = device dtype width (4 = f32)."""
    T, N, k = (int(d) for d in dims)
    panel = 2 * T * N                       # Ybuf + Wbuf
    params = N * k + N + 3 * k * k + k      # Lam, R, A/Q/P0, x0
    staging = 2 * max(0, int(r_max)) * N    # rows + rmask slice
    return float(bytes_per * (panel + params + staging))


@dataclass(frozen=True)
class Bucket:
    """One padded shape: ``dims`` = (T, N, k) every member is padded to,
    ``jobs`` = original submit-order indices, ``cap`` = max member
    iteration budget (the bucket program's worst-case chunk count)."""

    dims: Tuple[int, int, int]
    jobs: Tuple[int, ...]
    cap: int


@dataclass
class BucketPlan:
    """The planner's output: buckets plus the waste/cost accounting the
    scheduler and ``obs.advise --jobs`` both report."""

    buckets: List[Bucket]
    bucket_of: List[int]            # job index -> bucket index
    job_pad_waste: List[float]      # per-job padded-flop waste fraction
    pad_waste_frac: float           # aggregate: 1 - true/padded flops
    predicted_wall_s: float         # DP objective value of the chosen plan
    n_executables: int = field(init=False)

    def __post_init__(self):
        self.n_executables = len({b.dims for b in self.buckets})


def _prior_model(device: str = "cpu") -> CostModel:
    prior = DEFAULT_COEFFS.get(device, DEFAULT_COEFFS["cpu"])
    return CostModel(device=device, calibrated=False, **prior)


def _bucket_cost(model: CostModel, dims: Tuple[int, int, int],
                 iters: Sequence[int], chunk: int) -> float:
    """Predicted wall for one bucket: fixed overhead, the dispatch stream
    for the slowest member's cap (plus one smoother dispatch), and every
    member's iterations at the PADDED per-iteration rate."""
    T, N, k = dims
    cap = max(iters)
    nd = model.dispatches(cap, engine="chunked", chunk=chunk, depth=1) + 1
    it = model.iter_s(N, T, k)
    return (model.overhead_s + nd * model.dispatch_floor_s
            + sum(iters) * it)


def plan_buckets(shapes: Sequence[Tuple[int, int, int]],
                 iters: Optional[Sequence[int]] = None, *,
                 max_buckets: int = 3, model: Optional[CostModel] = None,
                 chunk: int = 8) -> BucketPlan:
    """Partition jobs with shapes ``[(T, N, k), ...]`` into at most
    ``max_buckets`` shape buckets minimizing predicted wall time.

    ``iters`` is each job's iteration budget (defaults to 50); ``model``
    a calibrated :class:`~dfm_tpu.obs.cost.CostModel` (defaults to cpu
    priors — relative rankings, which is all bucketing needs, survive
    uncalibrated coefficients).  Deterministic: ties prefer fewer
    buckets, then the lexicographically smallest cut positions.
    """
    B = len(shapes)
    if B == 0:
        return BucketPlan([], [], [], 0.0, 0.0)
    shapes = [(int(T), int(N), int(k)) for (T, N, k) in shapes]
    its = [50] * B if iters is None else [int(x) for x in iters]
    if len(its) != B:
        raise ValueError("iters must match shapes length")
    if any(x < 1 for x in its):
        raise ValueError("iteration budgets must be >= 1")
    m = model if model is not None else _prior_model()
    max_buckets = max(1, int(max_buckets))

    # Deterministic cost order: cheap jobs first, shape then index as
    # tie-breaks so equal-cost shapes stay grouped.
    order = sorted(range(B),
                   key=lambda i: (m.iter_s(shapes[i][1], shapes[i][0],
                                           shapes[i][2]), shapes[i], i))

    # group_cost[i][j]: cost of packing sorted slice [i, j] as ONE bucket.
    dims_ij: List[List[Tuple[int, int, int]]] = [[None] * B for _ in range(B)]
    cost_ij = [[0.0] * B for _ in range(B)]
    for i in range(B):
        T, N, k = shapes[order[i]]
        for j in range(i, B):
            Tj, Nj, kj = shapes[order[j]]
            T, N, k = max(T, Tj), max(N, Nj), max(k, kj)
            dims_ij[i][j] = (T, N, k)
            cost_ij[i][j] = _bucket_cost(
                m, (T, N, k), [its[order[x]] for x in range(i, j + 1)],
                chunk)

    # DP over contiguous partitions: state key (cost, n_groups, cuts)
    # compares deterministically — fewer groups then smaller cuts on ties.
    INF = (float("inf"), 0, ())
    dp = [[INF] * (max_buckets + 1) for _ in range(B + 1)]
    dp[0][0] = (0.0, 0, ())
    for j in range(1, B + 1):
        for g in range(1, max_buckets + 1):
            best = INF
            for i in range(j):
                prev = dp[i][g - 1]
                if prev[0] == float("inf"):
                    continue
                cand = (prev[0] + cost_ij[i][j - 1], g, prev[2] + (i,))
                if cand < best:
                    best = cand
            dp[j][g] = best
    final = min(dp[B][g] for g in range(1, max_buckets + 1))
    cuts = list(final[2]) + [B]

    buckets: List[Bucket] = []
    bucket_of = [0] * B
    for bi in range(len(cuts) - 1):
        lo, hi = cuts[bi], cuts[bi + 1]
        members = tuple(sorted(order[x] for x in range(lo, hi)))
        dims = dims_ij[lo][hi - 1]
        for ji in members:
            bucket_of[ji] = bi
        buckets.append(Bucket(dims=dims, jobs=members,
                              cap=max(its[ji] for ji in members)))

    true_fl = padded_fl = 0.0
    job_waste = [0.0] * B
    for ji in range(B):
        T, N, k = shapes[ji]
        bT, bN, bk = buckets[bucket_of[ji]].dims
        f_true = em_iter_work(N, T, k)[0] * its[ji]
        f_pad = em_iter_work(bN, bT, bk)[0] * its[ji]
        true_fl += f_true
        padded_fl += f_pad
        job_waste[ji] = 1.0 - f_true / f_pad if f_pad > 0 else 0.0
    agg = 1.0 - true_fl / padded_fl if padded_fl > 0 else 0.0
    return BucketPlan(buckets, bucket_of, job_waste, agg, final[0])


def plan_capacity_classes(shapes: Sequence[Tuple[int, int, int]],
                          iters: Optional[Sequence[int]] = None, *,
                          max_classes: int = 3,
                          model: Optional[CostModel] = None) -> BucketPlan:
    """Assign fleet tenants to serving CAPACITY CLASSES.

    ``shapes`` are per-tenant (T_capacity, N, k) — the padded panel each
    tenant needs resident — and ``iters`` the per-TICK warm-EM budget
    (default 5, the serve default).  A class is a bucket whose dims every
    member is padded to; each class costs ONE fused ``serve_update``
    dispatch per tick, so the DP runs with the chunk set to the largest
    budget (the whole tick is one program: ``dispatches == 1`` per class
    in the cost), trading per-tick padded-iteration waste against one
    extra dispatch + executable per additional class — the same
    calibrated coefficients ``obs.advise`` uses, deterministic.
    Returned as a plain :class:`BucketPlan` (class ==
    bucket; ``pad_waste_frac`` is the fleet bench's
    ``fleet_pad_waste_frac``).
    """
    its = ([5] * len(shapes) if iters is None
           else [int(x) for x in iters])
    cap = max(its) if its else 1
    return plan_buckets(shapes, its, max_buckets=max_classes, model=model,
                        chunk=max(1, cap))
