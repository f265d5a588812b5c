"""The calibrated cost model of the fleet's admission control.

The framework-free part of ``dfm_tpu.obs.cost``, copied: ``CostModel`` /
``fit_cost_model`` calibrate per-device coefficients (dispatch floor,
per-flop / per-byte throughput, scan-step overhead) from the ``profile``
records of the run registry (``obs.store``), and ``em_iter_work`` is the
closed-form work proxy of one EM iteration.  With an empty registry the
model is the uncalibrated device prior.  The XLA half of the JAX module
(``program_cost``, its memory statistics, ``RecompileDetector``) reads
compiled XLA executables and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import median
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["CostModel", "fit_cost_model", "em_iter_work", "DEFAULT_COEFFS"]


def em_iter_work(N: int, T: int, k: int) -> Tuple[float, float]:
    """Closed-form (flops, bytes) proxy for ONE EM iteration of the
    info-filter fit at panel shape (N, T, k): per time step the E-step
    forms C'R^-1 y (Nk), C'R^-1 C (Nk^2) and a handful of k-by-k
    factorizations/solves (k^3); the smoother and M-step sweeps are the
    same order.  Constants don't matter — calibration scales them — the
    proxy only has to get the SHAPE dependence right so profiles at one
    shape extrapolate to another."""
    flops = 2.0 * T * (N * k + N * k * k + 8.0 * k ** 3)
    bytes_ = 8.0 * T * (N + N * k + 4.0 * k * k)
    return float(flops), float(bytes_)


# Structured priors per device class — the fallback when the registry has
# no profiles, and the shape calibration scales (the JAX package's values:
# its tpu row is a TPU's ~80 ms dispatch floor and MXU-fed matmuls).
DEFAULT_COEFFS: Dict[str, Dict[str, float]] = {
    "tpu": {"dispatch_floor_s": 0.08, "step_s": 2e-5,
            "per_flop_s": 1.0 / 2e12, "per_byte_s": 1.0 / 4e10,
            "overhead_s": 0.3},
    "cpu": {"dispatch_floor_s": 1e-3, "step_s": 4e-5,
            "per_flop_s": 1.0 / 5e9, "per_byte_s": 1.0 / 1e10,
            "overhead_s": 0.05},
}


# The parallel-in-time QR engine trades the O(T) sequential scan depth
# for ~2*sqrt(T) blocked-prefix-scan steps at a constant-factor flop
# overhead (square-root element build + thin-QR combines).  The factor is
# a structural prior — profiles anchor the real number per shape.
PIT_QR_FLOP_MULT = 4.0

# The rank-r computation-aware engine keeps the O(T) depth but strips the
# k x k linalg out of the scan body (only r x r factorizations + plain
# matmuls remain), cutting per-iteration flops by roughly half at the
# profiled shapes.  A structural prior like PIT_QR_FLOP_MULT — measured
# "lowrank" profiles carry the real residual via ``lowrank_scale``.
LOWRANK_FLOP_MULT = 0.5


def _norm_plan(engine: str, chunk, depth, bucket, filt=None) -> Tuple:
    return (str(engine), int(chunk or 8), int(depth or 1), bool(bucket),
            str(filt or "seq"))


def _pad_plan(plan) -> List:
    """Legacy 4-element plan lists (pre-filter registries) mean the
    sequential time scan."""
    plan = list(plan)
    return plan + ["seq"] if len(plan) == 4 else plan


def _profile_plan(config: dict) -> Optional[Tuple]:
    """Map a ProfileRecord config to a normalized plan tuple (the
    ``pipelined`` variant is the chunked engine at depth>1; the
    ``pit_qr`` variant is the chunked engine under the parallel-in-time
    QR filter)."""
    variant = config.get("profile")
    flt = config.get("filter")
    if variant == "fused":
        return _norm_plan("fused", config.get("chunk"), 1, False, flt)
    if variant in ("chunked", "pipelined", "pit_qr", "lowrank"):
        depth = config.get("depth") or (2 if variant == "pipelined" else 1)
        return _norm_plan("chunked", config.get("chunk"), depth,
                          config.get("bucket"),
                          variant if variant in ("pit_qr", "lowrank")
                          else flt)
    return None


def _iter_features(T: float, flops: float, bytes_: float,
                   filt: str = "seq") -> Tuple[float, float, float]:
    """Per-iteration cost features under a time-scan engine: sequential
    depth, flops, bytes.  pit_qr replaces the T-step depth with the
    blocked prefix scan's ~2*sqrt(T) and pays the element/combine flop
    multiplier — the SAME feature map calibration and prediction use, so
    pit_qr profiles sharpen the shared coefficients instead of skewing
    them."""
    if filt == "pit_qr":
        return (2.0 * math.sqrt(max(T, 1.0)), PIT_QR_FLOP_MULT * flops,
                PIT_QR_FLOP_MULT * bytes_)
    if filt == "lowrank":
        # Same T-step depth; the scan body sheds its k x k linalg.
        return (float(T), LOWRANK_FLOP_MULT * flops,
                LOWRANK_FLOP_MULT * bytes_)
    return (float(T), float(flops), float(bytes_))


@dataclasses.dataclass
class CostModel:
    """Wall-time predictor for a fit plan at shape (N, T, k).

    ``predicted = overhead + n_program_dispatches * dispatch_floor +
    iters * iter_s(N, T, k)`` where ``iter_s = steps*step_s +
    flops*per_flop + bytes*per_byte`` with ``steps = T`` for the
    sequential scan and ``~2*sqrt(T)`` (at a flop multiplier) for the
    ``pit_qr`` time-parallel engine — and when the registry holds a
    profile at the EXACT plan+shape, the prediction is anchored to that
    measured warm median instead (extrapolated across iteration counts
    by the model's own marginal rate)."""

    device: str = "cpu"
    dispatch_floor_s: float = 1e-3
    step_s: float = 4e-5
    per_flop_s: float = 2e-10
    per_byte_s: float = 1e-10
    overhead_s: float = 0.05
    calibrated: bool = False
    n_profiles: int = 0
    # Residual multiplier for the pit_qr feature family: the structural
    # prior (2*sqrt(T) depth, 4x flops) is corrected by the measured
    # pit_qr profiles so an UNmeasured pit_qr plan never undercuts the
    # family's own measurements at other knobs.
    pit_qr_scale: float = 1.0
    # Same construction for the rank-r downdate family: LOWRANK_FLOP_MULT
    # is the structural prior, measured "lowrank" profiles correct it.
    lowrank_scale: float = 1.0
    # Whether the residual scales above come from measured family
    # profiles (vs the un-corrected structural prior).  The advisor uses
    # these to keep an UNmeasured engine-switch plan from undercutting
    # measured plans on raw-prior optimism — picking an engine nobody
    # profiled forces a fresh compile, the one cost the model can't see.
    pit_qr_calibrated: bool = False
    lowrank_calibrated: bool = False
    anchors: List[dict] = dataclasses.field(default_factory=list)

    def iter_s(self, N: int, T: int, k: int, filt: str = "seq") -> float:
        flops, bytes_ = em_iter_work(N, T, k)
        steps, flops, bytes_ = _iter_features(T, flops, bytes_, filt)
        it = (self.step_s * steps + self.per_flop_s * flops
              + self.per_byte_s * bytes_)
        if filt == "pit_qr":
            return it * self.pit_qr_scale
        if filt == "lowrank":
            return it * self.lowrank_scale
        return it

    def dispatches(self, iters: int, *, engine: str, chunk: int = 8,
                   depth: int = 1) -> int:
        """Program dispatches the host pays the dispatch floor for."""
        if engine == "fused":
            return 1
        n_chunks = max(1, math.ceil(iters / max(1, chunk)))
        return max(1, math.ceil(n_chunks / max(1, depth)))

    def _anchor(self, plan: Tuple, N: int, T: int, k: int):
        cands = [a for a in self.anchors
                 if _pad_plan(a["plan"]) == list(plan)
                 and (a["N"], a["T"], a["k"]) == (N, T, k)]
        return max(cands, key=lambda a: a["iters"]) if cands else None

    def predict(self, N: int, T: int, k: int, iters: int, *,
                engine: str, chunk: int = 8, depth: int = 1,
                bucket: bool = False, filter: str = "seq") -> dict:
        plan = _norm_plan(engine, chunk, depth, bucket, filter)
        it = self.iter_s(N, T, k, filter)
        anchor = self._anchor(plan, N, T, k)
        if anchor is not None:
            # Measured wall at this exact config; the model only fills in
            # the marginal cost of the iteration-count difference.
            wall = (float(anchor["warm_wall_s"])
                    + (iters - int(anchor["iters"])) * it
                    + (self.dispatches(iters, engine=engine, chunk=chunk,
                                       depth=depth)
                       - self.dispatches(int(anchor["iters"]),
                                         engine=engine, chunk=chunk,
                                         depth=depth))
                    * self.dispatch_floor_s)
            return {"predicted_wall_s": max(wall, 1e-9), "anchored": True}
        nd = self.dispatches(iters, engine=engine, chunk=chunk, depth=depth)
        wall = self.overhead_s + nd * self.dispatch_floor_s + iters * it
        return {"predicted_wall_s": max(wall, 1e-9), "anchored": False}

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["n_anchors"] = len(d.pop("anchors"))
        return d


def _solve3(A: List[List[float]], b: List[float]) -> Optional[List[float]]:
    """Gaussian elimination for the 3x3 normal equations (pure Python)."""
    m = [row[:] + [v] for row, v in zip(A, b)]
    for col in range(3):
        piv = max(range(col, 3), key=lambda r: abs(m[r][col]))
        if abs(m[piv][col]) < 1e-30:
            return None
        m[col], m[piv] = m[piv], m[col]
        for r in range(3):
            if r != col:
                f = m[r][col] / m[col][col]
                m[r] = [a - f * c for a, c in zip(m[r], m[col])]
    return [m[i][3] / m[i][i] for i in range(3)]


def fit_cost_model(profiles: Iterable[dict],
                   device: Optional[str] = None) -> CostModel:
    """Calibrate a ``CostModel`` from ProfileRecords (``obs.profile``).

    Coefficients come from measured walls: the dispatch floor is the
    median measured per-dispatch cost; the per-iteration rate is a
    3-parameter least squares over (scan steps, flops, bytes) features
    when the profiles span enough distinct shapes, else a single measured
    scale applied to the structured device prior.  Static ``program_cost``
    flops/bytes captured by the profiler replace the closed-form proxy
    for their observation.  With an empty registry the prior is returned
    un-calibrated (``calibrated=False``)."""
    profs = [p for p in profiles
             if p.get("kind") == "profile" and isinstance(p.get("config"),
                                                          dict)]
    if device is None and profs:
        device = profs[-1]["config"].get("device")
    device = device or "cpu"
    profs = [p for p in profs if p["config"].get("device") in (None, device)]
    prior = DEFAULT_COEFFS.get(device, DEFAULT_COEFFS["cpu"])
    model = CostModel(device=device, calibrated=False, n_profiles=len(profs),
                      **prior)
    if not profs:
        return model

    # Dispatch floor: median measured per-dispatch wall.
    floors = [float(p["metrics"]["dispatch_ms_per_program"]) / 1e3
              for p in profs
              if isinstance(p.get("metrics", {}).get(
                  "dispatch_ms_per_program"), (int, float))]
    if floors:
        model.dispatch_floor_s = max(median(floors), 0.0)

    # Per-iteration observations: (features, measured iter seconds).
    obs = []
    for p in profs:
        c, m = p["config"], p.get("metrics", {})
        it_ms = m.get("sustained_ms_per_iter") or m.get("ms_per_iter_warm")
        if not isinstance(it_ms, (int, float)) or it_ms <= 0:
            continue
        if not all(isinstance(c.get(x), int) for x in ("N", "T", "k")):
            continue
        N, T, k = c["N"], c["T"], c["k"]
        flops, bytes_ = em_iter_work(N, T, k)
        if isinstance(m.get("flops_per_iter"), (int, float)):
            flops = float(m["flops_per_iter"])
        if isinstance(m.get("bytes_per_iter"), (int, float)):
            bytes_ = float(m["bytes_per_iter"])
        prof = c.get("profile")
        flt = (prof if prof in ("pit_qr", "lowrank")
               else c.get("filter") or "seq")
        obs.append((_iter_features(T, flops, bytes_, flt),
                    float(it_ms) / 1e3, (N, T, k, flt)))

    if obs:
        model.calibrated = True
        # Shared coefficients come from the sequential-scan profiles; the
        # pit_qr family carries its own residual scale below (a registry
        # with ONLY pit_qr profiles still calibrates, off those).
        seq_obs = [o for o in obs if o[2][3] == "seq"] or obs
        coeffs = None
        if len({shape for _, _, shape in seq_obs}) >= 3:
            # Enough shape diversity for a genuine 3-param fit (tiny ridge
            # keeps the normal equations sane when features correlate).
            A = [[0.0] * 3 for _ in range(3)]
            rhs = [0.0] * 3
            for f, y, _ in seq_obs:
                for i in range(3):
                    rhs[i] += f[i] * y
                    for j in range(3):
                        A[i][j] += f[i] * f[j]
            for i in range(3):
                A[i][i] *= 1.0 + 1e-9
            sol = _solve3(A, rhs)
            if sol is not None and all(c >= 0.0 for c in sol):
                coeffs = sol
        if coeffs is None:
            # Scaled prior: one measured scalar corrects the whole prior
            # rate — robust down to a single profile.
            def prior_it(f):
                return (prior["step_s"] * f[0] + prior["per_flop_s"] * f[1]
                        + prior["per_byte_s"] * f[2])
            scale = median([y / prior_it(f) for f, y, _ in seq_obs])
            coeffs = [prior["step_s"] * scale, prior["per_flop_s"] * scale,
                      prior["per_byte_s"] * scale]
        model.step_s, model.per_flop_s, model.per_byte_s = coeffs

        def model_it(f):
            return (model.step_s * f[0] + model.per_flop_s * f[1]
                    + model.per_byte_s * f[2])
        pit_obs = [(f, y) for f, y, s in obs if s[3] == "pit_qr"]
        if pit_obs:
            model.pit_qr_scale = median(
                [y / max(model_it(f), 1e-30) for f, y in pit_obs])
            model.pit_qr_calibrated = True
        lowrank_obs = [(f, y) for f, y, s in obs if s[3] == "lowrank"]
        if lowrank_obs:
            model.lowrank_scale = median(
                [y / max(model_it(f), 1e-30) for f, y in lowrank_obs])
            model.lowrank_calibrated = True

    # Anchors + fixed overhead residual.
    overheads = []
    for p in profs:
        c, m = p["config"], p.get("metrics", {})
        plan = _profile_plan(c)
        warm = m.get("warm_wall_s")
        iters = c.get("iters")
        if plan is None or not isinstance(warm, (int, float)) \
                or not isinstance(iters, int):
            continue
        if not all(isinstance(c.get(x), int) for x in ("N", "T", "k")):
            continue
        N, T, k = c["N"], c["T"], c["k"]
        model.anchors.append({"plan": list(plan), "N": N, "T": T, "k": k,
                              "iters": iters,
                              "warm_wall_s": float(warm)})
        engine, chunk, depth, _, flt = plan
        # A measured wall at any knob of an engine-switch family is
        # evidence the family was profiled (even without iter metrics).
        if flt == "pit_qr":
            model.pit_qr_calibrated = True
        elif flt == "lowrank":
            model.lowrank_calibrated = True
        nd = model.dispatches(iters, engine=engine, chunk=chunk, depth=depth)
        ov = (float(warm) - nd * model.dispatch_floor_s
              - iters * model.iter_s(N, T, k, flt))
        overheads.append(max(ov, 0.0))
    if overheads:
        model.overhead_s = median(overheads)
    return model
