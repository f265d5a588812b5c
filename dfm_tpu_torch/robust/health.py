"""Per-fit and per-session health records (a copy).

The port's own copy of the JAX package's ``dfm_tpu.robust.health``
(framework-free; the port imports nothing of ``dfm_tpu``).  A
``FitHealth`` is the forensic trail of a fit or a serving session:
``ok`` distinguishes "clean" from "needed intervention", ``events`` lists
what was seen and done.  ``NowcastSession.health`` is one, as in the
JAX package, and stays empty: there, as here, only the guarded session
(``robust=``, ROADMAP Queue 1 item 5) records events, a kept-last-good
divergence among them; the unguarded session warns.  The JAX package
mirrors each recorded event into its tracer or live plane; the port has
neither yet (item 13), so ``record`` only stores the event.
``health_from_trace`` is the post-hoc record of a loglik trace, which
each lane of ``fit_many`` gets.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

__all__ = ["HealthEvent", "FitHealth", "health_from_trace"]

# Event kinds the guard emits:
#   nan_loglik      non-finite loglik in a chunk
#   divergence      loglik drop beyond the noise floor
#   freeze_drift    ss freeze delta above the policy threshold
#   stall           successive chunks wiggling inside the noise floor
#   nonpsd          Q or P0 lost positive semi-definiteness
#   r_floor         R entries pinned at the EM floor
#   nonfinite_params  NaN/inf in the parameter pytree itself
#   dispatch_error  device dispatch raised (tunnel error / timeout)
# The live plane (obs/live.py) adds:
#   slo_burn        SLO error-budget burn crossed fire/clear hysteresis
#   latency_anomaly p99 spike vs the rolling baseline
# The serving daemon adds:
#   shed            overload load-shed: a request rejected while the SLO
#                   burn signal fired (lowest-priority tenants first)
#   handoff         blue/green listener handoff (detail carries gap_ms)


@dataclasses.dataclass
class HealthEvent:
    """One observed pathology and what the guard did about it."""

    chunk: int          # fused-chunk index (0-based)
    iteration: int      # EM iteration count at the chunk entry
    kind: str
    detail: str = ""
    action: str = "none"   # retried | restored | repaired | remeasure_tau
    #                      # | fallback_info | loglik_f64 | stopped | abort
    t: float = 0.0      # time.perf_counter() at record time (0 = unstamped);
    #                   # monotonic, comparable to obs.trace event times
    engine: str = ""    # emitting engine ("tpu_em", "batched_em", ...)
    tenant: str = ""    # fit_jobs tenant id (multi-tenant attribution)
    session: str = ""   # NowcastSession id (serving attribution)
    backoff_s: float = 0.0  # sleep charged to this event before the retry
    trace_id: str = ""  # request trace this pathology struck (obs.trace)

    def __str__(self) -> str:
        eng = f" {self.engine}" if self.engine else ""
        who = ""
        if self.tenant:
            who += f" tenant={self.tenant}"
        if self.session:
            who += f" session={self.session}"
        return (f"[chunk {self.chunk} it {self.iteration}]{eng}{who} "
                f"{self.kind} -> {self.action}"
                + (f" ({self.detail})" if self.detail else ""))


@dataclasses.dataclass
class FitHealth:
    """Aggregate health of one EM run (attached to ``FitResult.health``)."""

    n_chunks: int = 0
    n_dispatch_retries: int = 0
    n_recoveries: int = 0
    max_ss_delta: float = 0.0
    monotonicity_violations: int = 0
    r_floor_hits: int = 0
    nonpsd_events: int = 0
    stalled: bool = False
    escalations: List[str] = dataclasses.field(default_factory=list)
    events: List[HealthEvent] = dataclasses.field(default_factory=list)
    fallback_backend: Optional[str] = None
    engine: str = ""    # default engine name stamped onto recorded events

    @property
    def ok(self) -> bool:
        """True iff the fit needed no intervention of any kind."""
        return (not self.events and not self.escalations
                and self.fallback_backend is None and not self.stalled)

    def record(self, event: HealthEvent, emit: bool = True) -> HealthEvent:
        """Record ``event`` (stamping time/engine).  ``emit`` is kept for
        the JAX package's signature: there is no telemetry stream to
        mirror the event into yet."""
        if event.t == 0.0:
            event.t = time.perf_counter()
        if not event.engine:
            event.engine = self.engine
        self.events.append(event)
        if event.kind == "nonpsd":
            self.nonpsd_events += 1
        if event.action in ("restored", "repaired", "retried"):
            self.n_recoveries += 1
        return event

    def escalate(self, action: str) -> None:
        self.escalations.append(action)

    def summary(self) -> str:
        if self.ok:
            return f"healthy ({self.n_chunks} chunks)"
        bits = [f"{len(self.events)} events"]
        if self.escalations:
            bits.append("escalations: " + ",".join(self.escalations))
        if self.fallback_backend:
            bits.append(f"fell back to {self.fallback_backend}")
        if self.stalled:
            bits.append("stalled")
        return "; ".join(bits)


def health_from_trace(lls, noise_floor: float = 0.0,
                      max_ss_delta: float = 0.0,
                      engine: str = "") -> FitHealth:
    """Post-hoc health record from a loglik trace: a ``nan_loglik`` event
    for each of the first 8 non-finite entries, the count of drops beyond
    ``noise_floor`` and the ss freeze delta where the engine reports one
    (``max_ss_delta``).  No device work."""
    h = FitHealth(engine=engine)
    a = np.asarray(lls, np.float64)
    for i in np.flatnonzero(~np.isfinite(a))[:8]:
        h.record(HealthEvent(chunk=-1, iteration=int(i), kind="nan_loglik",
                             detail="non-finite loglik in trace"))
    if a.size >= 2:
        drops = a[:-1] - a[1:]
        with np.errstate(invalid="ignore"):
            h.monotonicity_violations = int(np.sum(drops > noise_floor))
    h.max_ss_delta = float(max_ss_delta)
    return h
