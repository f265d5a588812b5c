"""Model families beyond the plain DFM (the twin of ``dfm_tpu.models``).

Ported so far: the time-varying-loadings family (config S4,
``tv_loadings``) and the mixed-frequency nowcasting family (config S3,
``mixed_freq``).  The stochastic-volatility family is not ported yet
(ROADMAP Queue 1 item 11).
"""

from .mixed_freq import (MFParams, MFResult, MixedFreqSpec, mf_fit,
                         mf_forecast, mf_loglik_eval)
from .tv_loadings import (TVLParams, TVLResult, TVLSpec, tvl_fit,
                          tvl_forecast)

__all__ = ["TVLSpec", "TVLParams", "TVLResult", "tvl_fit", "tvl_forecast",
           "MixedFreqSpec", "MFParams", "MFResult", "mf_fit", "mf_forecast",
           "mf_loglik_eval"]
