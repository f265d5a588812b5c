"""dfm_tpu_torch: the PyTorch/CUDA port of dfm_tpu.

Dynamic factor models estimated by EM with an information-form Kalman
filter, on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``,
built at first use by ``kernels``), or on the CPU through each kernel's
plain-torch version.  ``fit(fused=...)`` is the fused fit with nowcast and
forecasts; ``open_session`` streams updates into a fitted model.  The
package imports neither JAX nor ``dfm_tpu``.
"""

from .api import DynamicFactorModel, FitResult, TorchBackend, fit, forecast
from .estim.fused import FusedOptions
from .kernels import LAUNCHES
from .serve import NowcastSession, open_session
from .ssm.params import SSMParams

__all__ = ["DynamicFactorModel", "FitResult", "TorchBackend", "fit",
           "forecast", "FusedOptions", "NowcastSession", "open_session",
           "SSMParams", "LAUNCHES"]
