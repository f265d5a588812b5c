"""Model families beyond the plain DFM (the twin of ``dfm_tpu.models``).

Ported: the time-varying-loadings family (config S4, ``tv_loadings``),
the mixed-frequency nowcasting family (config S3, ``mixed_freq``) and the
stochastic-volatility family (config S5, ``sv``).
"""

from .mixed_freq import (MFParams, MFResult, MixedFreqSpec, mf_fit,
                         mf_forecast, mf_loglik_eval)
from .sv import (FFBSDraws, SVDraws, SVFit, SVResult, SVSpec, sv_filter,
                 sv_fit, sv_forecast, sv_smooth_h)
from .tv_loadings import (TVLParams, TVLResult, TVLSpec, tvl_fit,
                          tvl_forecast)

__all__ = ["TVLSpec", "TVLParams", "TVLResult", "tvl_fit", "tvl_forecast",
           "MixedFreqSpec", "MFParams", "MFResult", "mf_fit", "mf_forecast",
           "mf_loglik_eval", "SVSpec", "SVResult", "SVFit", "SVDraws",
           "FFBSDraws", "sv_filter", "sv_smooth_h", "sv_fit", "sv_forecast"]
