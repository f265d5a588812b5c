"""Model families beyond the plain DFM (the twin of ``dfm_tpu.models``).

Ported so far: the time-varying-loadings family (config S4,
``tv_loadings``).  The mixed-frequency and stochastic-volatility families
are not ported yet (ROADMAP Queue 1 item 11).
"""

from .tv_loadings import (TVLParams, TVLResult, TVLSpec, tvl_fit,
                          tvl_forecast)

__all__ = ["TVLSpec", "TVLParams", "TVLResult", "tvl_fit", "tvl_forecast"]
