"""Public API: ``DynamicFactorModel`` + ``fit(model, Y, backend=...)``.

The PyTorch twin of ``dfm_tpu.api`` for plain DFM fits:
standardize -> PCA init -> chunked EM (or, with ``fused=``, the fused fit
of ``estim.fused``: EM to convergence, smooth, nowcast and forecasts) ->
reporting smooth, and ``forecast``; ``keep_session=`` opens a streaming
``serve.NowcastSession`` on the fit.  ``fit`` also takes a
``models.TVLSpec`` (the time-varying-loadings family, ``tvl_fit``), a
``models.MixedFreqSpec`` (the mixed-frequency family, ``mf_fit``) and a
``models.SVSpec`` (the stochastic-volatility family, ``sv_fit``), as the
JAX package's ``fit`` routes its family specs.  ``TorchBackend`` runs on CUDA
unless the caller asks for the CPU (``device="cpu"``), where every
kernel's plain version runs instead; a CUDA backend on a machine without
a card raises.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .backends import cpu_ref
from .estim.em import EMConfig, fit_em_chunked, noise_floor_for
from .estim.fused import resolve_fused, run_fused
from .estim.init import pca_init_device, standardize_device
from .models.mixed_freq import (MFParams, MFResult, MixedFreqSpec, mf_fit,
                                mf_forecast)
from .models.sv import SVFit, SVSpec, sv_fit, sv_forecast
from .models.tv_loadings import (TVLParams, TVLResult, TVLSpec, tvl_fit,
                                 tvl_forecast)
from .ops.precision import default_compute_dtype, highest_precision
from .ssm.info_filter import smooth
from .ssm.params import SSMParams
from .ssm.steady import auto_tau
from .utils import refuse_unported
from .utils.data import (Standardizer, build_mask, standardize,
                         standardize_onepass, validate_panel)

__all__ = ["DynamicFactorModel", "FitResult", "TorchBackend", "fit",
           "forecast"]

# Gate of the device-side standardize and PCA init (element count).
_DEVICE_INIT_MIN_SIZE = 4_000_000
_FILTERS = ("auto", "dense", "info", "ss", "pit", "pit_qr", "lowrank")


@dataclasses.dataclass(frozen=True)
class DynamicFactorModel:
    """Model description (what to estimate), independent of any backend.

    dynamics: "static" (f_t iid N(0, I) — A = 0, Q = I fixed) or
              "ar1" (factor VAR(1), A and Q estimated).
    """

    n_factors: int
    dynamics: str = "ar1"
    standardize: bool = True
    estimate_init: bool = False

    def __post_init__(self):
        if self.dynamics not in ("static", "ar1"):
            raise ValueError(f"unknown dynamics {self.dynamics!r}")
        if self.n_factors < 1:
            raise ValueError("n_factors must be >= 1")

    @property
    def estimate_A(self) -> bool:
        return self.dynamics == "ar1"

    @property
    def estimate_Q(self) -> bool:
        return self.dynamics == "ar1"


@dataclasses.dataclass
class FitResult:
    """Everything a user needs after estimation, in NumPy float64."""

    params: cpu_ref.SSMParams          # in standardized units
    logliks: np.ndarray                # per-iteration loglik at entry params
    factors: np.ndarray                # (T, k) smoothed factor means
    factor_cov: np.ndarray             # (T, k, k) smoothed covariances
    converged: bool
    n_iters: int
    standardizer: Optional[Standardizer]
    model: DynamicFactorModel
    backend: str
    history: list                      # per-iter dicts {iter, loglik, secs}
    filter: Optional[str] = None       # resolved in-loop filter engine
    tau: Optional[int] = None          # steady-state horizon ("ss" only)
    ss_delta: Optional[float] = None   # largest ss freeze delta ("ss"
    #                                  # only; None on fused fits)
    nowcast: Optional[np.ndarray] = None   # fused fits only: (N,) Lam x_T
    #                                  # in ORIGINAL units
    forecasts: Optional[dict] = None   # fused fits only: {"y": (h, N)
    #                                  # state-space forecast in original
    #                                  # units, "f": (h, k) factor path,
    #                                  # "di": (N,) diffusion-index h-step
    #                                  # forecast or None}
    session: Optional[object] = None   # fit(keep_session=...) only: a
    #                                  # serve.NowcastSession on this fit
    host_reads: Optional[int] = None   # fused fits only: blocking
    #                                  # device->host reads of the EM loop
    #                                  # and its outputs

    @property
    def loglik(self) -> float:
        return float(self.logliks[-1]) if len(self.logliks) else float("nan")


class TorchBackend:
    """PyTorch backend.

    device: "cuda" (the default: the hand-written kernels) or "cpu" (every
    kernel's plain-torch version).  dtype: compute dtype, None for float32
    on CUDA and float64 on the CPU.  filter: "auto" (dense below N = 32,
    "ss" for unmasked panels at N >= 512, info otherwise — the JAX
    package's rule), "dense" (the N x N filter, kernel K15: N <= 128 and
    k <= 128 on CUDA, K15-gen past 32), "info", "ss" (steady-state; tau
    from the Riccati mixing time at the init params), "pit" (covariance-form
    parallel-in-time), "pit_qr" (square-root parallel-in-time; past k =
    10 the JAX package's Gram-and-Cholesky branches, whose f32 loglik is
    far from the exact one at large N, in both packages) or "lowrank" (the
    rank-r downdate engine for wide factor models,
    ``ssm.lowrank_filter``; on CUDA its kernels take k <= 128 and any
    r <= k, the generic ones past k = 100 or r = 32).  On CUDA "info",
    "ss", "pit", "pit_qr" and the rest of the "lowrank" path take k <= 128
    (``kernels.GEN_KMAX``), on the lone and the batched paths; past it a
    CUDA call raises naming the ROADMAP row.  rank: the
    rank r of "lowrank" (<= 0: auto, min(k, 8)); the other engines ignore
    it.  fused_chunk: EM
    iterations per device chunk between host reads.  device_init:
    standardize and PCA-init on the device ("auto": when N*T >= 4e6).
    """

    name = "torch"

    def __init__(self, device="cuda", dtype=None, filter: str = "auto",
                 fused_chunk: int = 8, device_init="auto", rank: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the plain-torch path")
        self.dtype = (default_compute_dtype(self.device) if dtype is None
                      else dtype)
        if filter not in _FILTERS:
            raise ValueError(f"unknown filter {filter!r}")
        self.filter = filter
        self.rank = int(rank)
        self.fused_chunk = max(1, int(fused_chunk))
        self.device_init = device_init

    def _use_device_init(self, size: int) -> bool:
        if self.device_init == "auto":
            return size >= _DEVICE_INIT_MIN_SIZE
        return bool(self.device_init)

    def _filter_for(self, N: int, masked: bool = False) -> str:
        if self.filter == "auto":
            if N < 32:
                return "dense"
            if not masked and N >= 512:
                return "ss"
            return "info"
        return self.filter

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype,
                               device=self.device).contiguous()

    def prep_standardize(self, Y: np.ndarray, model):
        """Device-side standardization for large fully-observed panels, or
        ``None`` when the host path should run.  Returns
        ``(Yz tensor, Standardizer)``."""
        if not model.standardize or not self._use_device_init(Y.size):
            return None
        if not bool(np.isfinite(Y).all()):
            return None
        Yz, stats = standardize_device(self.tensor(Y))
        stats = stats.to("cpu", torch.float64).numpy()
        return Yz, Standardizer(stats[0], stats[1])

    def default_init(self, Yt: torch.Tensor, Yz, mask, model):
        """PCA warm start: on the device for large panels (``Yt`` is the
        zero-filled device panel), else the NumPy f64 initializer on the
        host panel ``Yz``."""
        static = model.dynamics == "static"
        if self._use_device_init(Yt.numel()):
            return pca_init_device(Yt, model.n_factors, static=static)
        return cpu_ref.pca_init(Yz, model.n_factors, static=static,
                                mask=mask)


def fit(model, Y: np.ndarray,
        mask: Optional[np.ndarray] = None,
        backend: Optional[TorchBackend] = None,
        max_iters: Optional[int] = None, tol: Optional[float] = None,
        init=None, fused=False, keep_session=False,
        warm_start=None, callback=None, checkpoint_path=None,
        checkpoint_every=10, debug=False, robust=None, telemetry=None,
        progress=None, pipeline=None, auto=False, tune=None):
    """Estimate a DFM: standardize -> PCA init -> EM -> smooth.

    model : a ``DynamicFactorModel`` (returns a ``FitResult``) or a
        ``models.TVLSpec``: the time-varying-loadings family through
        ``tvl_fit`` on the backend's device, dtype and ``fused_chunk``
        (returns a ``TVLResult``; ``max_iters`` / ``tol`` override the
        spec's ``n_rounds`` / ``tol`` only when given, ``init`` must be a
        ``TVLParams``; ``fused=`` warns and is ignored, ``warm_start=`` and
        ``keep_session=`` raise ``TypeError``), or a
        ``models.MixedFreqSpec``: the mixed-frequency family through
        ``mf_fit`` likewise (returns an ``MFResult``; ``init`` an
        ``MFParams``, ``max_iters`` / ``tol`` as for a plain fit), or a
        ``models.SVSpec``: the stochastic-volatility family through
        ``sv_fit`` with the backend as its pre-fit's (returns an
        ``SVFit``; ``max_iters`` is the particle-EM round count
        ``sv_iters``, default 10, ``tol`` is ignored; a mask, NaN in Y or
        ``init`` raise ``ValueError``).
    Y    : (T, N) panel; NaNs mark missing observations.
    mask : optional explicit {0,1} mask, combined with the NaN pattern.
    backend : a ``TorchBackend``; None means ``TorchBackend()`` (CUDA).
    max_iters / tol : EM budget and relative-loglik stop (default 50 and
        1e-6).
    init : NumPy warm-start params (anything with Lam, A, Q, R, mu0, P0);
        None runs the PCA init.
    fused : the fused fit (``estim.fused``): ``True``, an int (the
        forecast horizon) or a ``FusedOptions``.  EM runs to convergence
        as gated device chunks (at most one 4-byte status read per chunk),
        then the reporting smooth, nowcast and forecasts, all read back in
        one packed read; the result gains ``nowcast`` and ``forecasts`` in
        original units.  A diverged fused fit returns the last-good params,
        not converged, smoothed as a chunked fit is, without them.
    keep_session : open a ``serve.NowcastSession`` on the fitted model
        (``FitResult.session``) on the same backend: ``True`` for the
        session defaults, a dict for ``open_session`` keywords.
    warm_start : not ported yet (ROADMAP Queue 1 item 3, with the fused
        fit's device-panel residency cache); pass ``init=prev.params``.
    callback, checkpoint_path, checkpoint_every, debug, telemetry,
    progress, auto (ROADMAP Queue 1 item 3), robust (item 5), pipeline
    (item 4), tune (item 9) : the JAX package's keywords; any value but
    the reference's default (``robust``: None or False, the port's fits
    being unguarded; ``telemetry``: None or False) raises
    ``NotImplementedError`` naming the item.
    """
    refuse_unported(
        "fit", ("callback", callback is not None, 3),
        ("checkpoint_path", checkpoint_path is not None, 3),
        ("checkpoint_every", checkpoint_every != 10, 3),
        ("debug", bool(debug), 3), ("robust", robust not in (None, False), 5),
        ("telemetry", telemetry not in (None, False), 3),
        ("progress", progress is not None, 3),
        ("pipeline", pipeline not in (None, 0), 4), ("auto", bool(auto), 3),
        ("tune", tune is not None, 9))
    if isinstance(model, (TVLSpec, MixedFreqSpec, SVSpec)):
        return _family_fit(model, Y, mask, backend, max_iters, tol, init,
                           fused, keep_session, warm_start)
    if not isinstance(model, DynamicFactorModel):
        raise TypeError(
            f"fit takes a MixedFreqSpec, an SVSpec, a DynamicFactorModel or "
            f"a TVLSpec; got {type(model).__name__}")
    if warm_start is not None:
        raise NotImplementedError(
            "fit(warm_start=) is not ported to dfm_tpu_torch yet: ROADMAP "
            "Queue 1 item 3; pass init=prev.params instead")
    b = TorchBackend() if backend is None else backend
    with highest_precision():
        res = _fit_impl(model, Y, mask, b, max_iters, tol, init,
                        resolve_fused(fused))
    if keep_session:
        from .serve.session import open_session
        skw = dict(keep_session) if isinstance(keep_session, dict) else {}
        res.session = open_session(res, Y, mask=mask, backend=b, **skw)
    return res


def _family_fit(model, Y, mask, backend, max_iters, tol, init, fused,
                keep_session, warm_start):
    """The twin of the JAX package's ``_family_fit``: the backend's dtype,
    device and ``fused_chunk`` carry over (for SV the whole backend drives
    the pre-fit and the particle EM); the options the family does not take
    raise or warn as there.  Returns the family's ``TVLResult``,
    ``MFResult`` or ``SVFit``."""
    name = type(model).__name__
    if warm_start is not None:
        raise TypeError(
            f"warm_start is only supported for DynamicFactorModel fits; "
            f"the {name} family has its own init= type")
    if keep_session:
        raise TypeError(f"keep_session: the {name} family has no streaming "
                        "session")
    if isinstance(model, SVSpec):
        if mask is not None or not bool(np.isfinite(np.asarray(Y)).all()):
            # sv_filter has no missing-data handling: NaNs would poison
            # the loglik and the vol paths.
            raise ValueError("the SV family does not support missing data")
        if init is not None:
            raise ValueError("sv_fit estimates its own warm start; init is "
                             "not supported (see models.sv.sv_fit)")
    else:
        params = MFParams if isinstance(model, MixedFreqSpec) else TVLParams
        if init is not None and not isinstance(init, params):
            raise TypeError(f"init for the {name} family must be "
                            f"{params.__name__}; got {type(init).__name__}")
    b = TorchBackend() if backend is None else backend
    kw = dict(mask=mask, init=init, dtype=b.dtype, device=b.device,
              fused_chunk=b.fused_chunk)
    if isinstance(model, SVSpec):
        res = sv_fit(Y, model, backend=b,
                     sv_iters=10 if max_iters is None else max_iters)
    elif isinstance(model, MixedFreqSpec):
        res = mf_fit(Y, model, max_iters=50 if max_iters is None
                     else max_iters, tol=1e-6 if tol is None else tol, **kw)
    else:
        spec = model
        if max_iters is not None or tol is not None:
            spec = dataclasses.replace(
                model, n_rounds=max_iters if max_iters is not None
                else model.n_rounds, tol=tol if tol is not None
                else model.tol)
        res = tvl_fit(Y, spec, **kw)
    if fused:
        warnings.warn(f"the {name} family has no fused while-loop driver; "
                      "ignoring fused=", RuntimeWarning, stacklevel=3)
    return res


def _fit_impl(model, Y, mask, b: TorchBackend, max_iters, tol, init,
              opts=None):
    max_iters = 50 if max_iters is None else max_iters
    tol = 1e-6 if tol is None else tol
    Y = np.asarray(Y)
    if Y.ndim != 2:
        raise ValueError(f"Y must be (T, N); got shape {Y.shape}")
    T, N = Y.shape
    if model.n_factors > min(T, N):
        raise ValueError(
            f"n_factors={model.n_factors} exceeds min(T, N)={min(T, N)}")
    if T < 2 and model.dynamics == "ar1":
        raise ValueError("ar1 dynamics needs T >= 2 (the M-step divides by T-1)")
    validate_panel(Y, mask, check_variance=model.standardize)

    dev_prep = b.prep_standardize(Y, model) if mask is None else None
    Yz = Wm = None
    std: Optional[Standardizer] = None
    if dev_prep is not None:
        Yt, std = dev_prep
    else:
        Y = np.asarray(Y, dtype=np.float64)
        W = build_mask(Y, mask)
        any_missing = bool((W == 0).any())
        if model.standardize:
            if not any_missing and Y.size >= _DEVICE_INIT_MIN_SIZE:
                out_dt = torch.empty((), dtype=b.dtype).numpy().dtype
                Y, std = standardize_onepass(Y, out_dtype=out_dt)
            else:
                Y, std = standardize(Y, mask=W if any_missing else None)
        Wm = W if any_missing else None
        Yz = Y if not any_missing else np.where(W > 0, np.nan_to_num(Y), 0.0)
        Yt = b.tensor(Yz)
    mt = b.tensor(Wm) if Wm is not None else None
    if init is None:
        init = b.default_init(Yt, Yz, Wm, model)
    flt = b._filter_for(N, mt is not None)
    cfg = EMConfig(estimate_A=model.estimate_A, estimate_Q=model.estimate_Q,
                   estimate_init=model.estimate_init, filter=flt,
                   rank=b.rank)
    if flt == "ss":
        # tau from the covariance recursion's mixing time at the init
        # params (host NumPy, k x k); the freeze delta guards it.
        cfg = dataclasses.replace(cfg, tau=auto_tau(init))
    p0 = SSMParams.from_numpy(init, dtype=b.dtype, device=b.device)
    if opts is not None:
        return _fit_fused(model, Yt, mt, p0, cfg, b, max_iters, tol, opts,
                          std)
    p, lls, converged, _, secs, max_delta = fit_em_chunked(
        Yt, mt, p0, cfg, max_iters, tol, b.fused_chunk)
    x_sm, P_sm = _report_smooth(Yt, p, mt, flt)
    history = [{"iter": i, "loglik": float(ll), "secs": s}
               for i, (ll, s) in enumerate(zip(lls, secs))]
    return FitResult(params=p.to_numpy(), logliks=np.asarray(lls),
                     factors=x_sm, factor_cov=P_sm,
                     converged=bool(converged), n_iters=len(lls),
                     standardizer=std, model=model, backend=b.name,
                     history=history, filter=flt,
                     tau=cfg.tau if flt == "ss" else None,
                     ss_delta=max_delta if flt == "ss" else None)


def _report_smooth(Yt, p: SSMParams, mt, flt: str):
    """The reporting smooth of a chunked fit, as host f64 arrays: dense
    through the N x N filter, every other engine (lowrank too, as in the
    JAX package) through the exact info-form pair."""
    x_sm, P_sm = smooth(Yt, p, mt, dense=(flt == "dense"))
    return (x_sm.to("cpu", torch.float64).numpy(),
            P_sm.to("cpu", torch.float64).numpy())


def _fit_fused(model, Yt, mt, p0: SSMParams, cfg: EMConfig,
               b: TorchBackend, max_iters, tol, opts, std) -> FitResult:
    """The fused fit (``estim.fused.run_fused``) and its FitResult.  A
    diverged run returns the last-good params, not converged, with the
    chunked fit's reporting smooth and no nowcast or forecasts."""
    floor = noise_floor_for(b.dtype, Yt.numel(), mult=cfg.noise_floor_mult)
    t0 = time.perf_counter()
    run = run_fused(Yt, mt, p0, cfg, max_iters, tol, floor, opts,
                    fused_chunk=b.fused_chunk)
    wall = time.perf_counter() - t0
    history = [{"iter": i, "loglik": float(ll), "secs": wall if i == 0
                else 0.0} for i, ll in enumerate(run.lls)]
    nowcast = forecasts = None
    if run.diverged:
        params = run.p_good
        x_sm, P_sm = _report_smooth(
            Yt, SSMParams.from_numpy(params, dtype=b.dtype, device=b.device),
            mt, cfg.filter)
    else:
        params, x_sm, P_sm = run.params, run.x_sm, run.P_sm
        inv = std.inverse if std is not None else (lambda a: a)
        nowcast = np.asarray(inv(run.nowcast))
        forecasts = {"y": np.asarray(inv(run.y_fore)), "f": run.f_fore,
                     "di": (np.asarray(inv(run.di)) if run.di is not None
                            else None)}
    return FitResult(params=params, logliks=run.lls, factors=x_sm,
                     factor_cov=P_sm, converged=run.converged,
                     n_iters=len(run.lls), standardizer=std, model=model,
                     backend=b.name, history=history, filter=cfg.filter,
                     tau=cfg.tau if cfg.filter == "ss" else None,
                     nowcast=nowcast, forecasts=forecasts,
                     host_reads=run.host_reads)


def forecast(result, horizon: int):
    """h-step-ahead forecasts in ORIGINAL data units (de-standardized).

    Returns (y_fore (h, N), f_fore (h, k)), iterating the factor dynamics
    from the last smoothed state; a ``TVLResult`` goes to ``tvl_forecast``
    (loadings frozen at T), an ``MFResult`` to ``mf_forecast`` (the
    augmented companion state), an ``SVFit`` to ``sv_forecast``
    (conditional means; its vol bands are ``sv_forecast``'s third return).
    """
    if isinstance(result, SVFit):
        return sv_forecast(result, horizon)[:2]
    if isinstance(result, MFResult):
        return mf_forecast(result, horizon)
    if isinstance(result, TVLResult):
        return tvl_forecast(result, horizon)
    f, y, _ = cpu_ref.forecast(result.params, result.factors[-1],
                               result.factor_cov[-1], horizon)
    if result.standardizer is not None:
        y = result.standardizer.inverse(y)
    return y, f
