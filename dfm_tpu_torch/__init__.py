"""dfm_tpu_torch: the PyTorch/CUDA port of dfm_tpu.

Dynamic factor models estimated by EM with an information-form Kalman
filter, on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``,
built at first use by ``kernels``), or on the CPU through each kernel's
plain-torch version.  ``fit(fused=...)`` is the fused fit with nowcast and
forecasts; ``open_session`` streams updates into a fitted model;
``fit_many`` fits B independent problems in one batched program (EM
restarts, ``select_n_factors_em``'s k-grid, ``oos_evaluate``'s rolling
windows); ``open_fleet`` serves many tenants' sessions, one batched tick
per capacity class; ``fit(TVLSpec(...), Y)`` (or ``tvl_fit``) estimates
the time-varying-loadings family, ``fit(MixedFreqSpec(...), Y,
mask=...)`` (or ``mf_fit``) the mixed-frequency nowcasting family and
``fit(SVSpec(...), Y)`` (or ``sv_fit``) the stochastic-volatility family.
The package imports neither JAX nor ``dfm_tpu``.
"""

from .api import DynamicFactorModel, FitResult, TorchBackend, fit, forecast
from .estim.batched import BatchFitResult, DFMBatchSpec, fit_many
from .estim.evaluate import OOSResult, oos_evaluate
from .estim.fused import FusedOptions
from .estim.select import EMSelectResult, select_n_factors_em
from .fleet import (FleetBucket, SessionFleet, TenantSlot, fleet_pad_waste,
                    open_fleet, plan_admission)
from .kernels import LAUNCHES
from .models import (FFBSDraws, MFParams, MFResult, MixedFreqSpec, SVDraws,
                     SVFit, SVResult, SVSpec, TVLParams, TVLResult, TVLSpec,
                     mf_fit, mf_forecast, mf_loglik_eval, sv_filter, sv_fit,
                     sv_forecast, sv_smooth_h, tvl_fit, tvl_forecast)
from .serve import NowcastSession, open_session
from .ssm.params import SSMParams

__all__ = ["DynamicFactorModel", "FitResult", "TorchBackend", "fit",
           "forecast", "FusedOptions", "NowcastSession", "open_session",
           "SSMParams", "LAUNCHES", "DFMBatchSpec", "BatchFitResult",
           "fit_many", "select_n_factors_em", "EMSelectResult",
           "oos_evaluate", "OOSResult", "open_fleet", "SessionFleet",
           "FleetBucket", "TenantSlot", "plan_admission", "fleet_pad_waste",
           "TVLSpec", "TVLParams", "TVLResult", "tvl_fit", "tvl_forecast",
           "MixedFreqSpec", "MFParams", "MFResult", "mf_fit", "mf_forecast",
           "mf_loglik_eval", "SVSpec", "SVResult", "SVFit", "SVDraws",
           "FFBSDraws", "sv_filter", "sv_smooth_h", "sv_fit", "sv_forecast"]
