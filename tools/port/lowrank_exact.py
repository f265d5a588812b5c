#!/usr/bin/env python3
"""The rank-r engine at rank = k against the exact filter, in the JAX
package at x64 on the CPU, on the inputs of ``chip_smoke.lgen_exact_phase``.

    JAX_PLATFORMS=cpu python3 tools/port/lowrank_exact.py

For each k of ``chip_smoke.LGEN_EXACT_KS`` (the masked 120 x 400 panel
``chip_smoke.panel`` simulates from seed 0 + LGEN_SEED + 20 + k), prints
one JSON line: the loglik of ``dfm_tpu.ssm.lowrank_filter.lowrank_filter``
at rank = k, that of ``dfm_tpu.ssm.info_filter.info_filter`` at the same
params, their relative gap (the figure ``chip_smoke.LGEN_EXACT_JAX``
holds, the limit of the card's own gap when it is above 1e-9), and the
same gap of the port's plain twins in f64.  No card is needed.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["JAX_ENABLE_X64"] = "1"
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dfm_tpu.ssm import info_filter as jinf  # noqa: E402
from dfm_tpu.ssm import lowrank_filter as jl  # noqa: E402
from dfm_tpu.ssm.params import SSMParams as JP  # noqa: E402
from dfm_tpu_torch.ssm import info_filter as tinf  # noqa: E402
from dfm_tpu_torch.ssm import lowrank_filter as tl  # noqa: E402
from dfm_tpu_torch.ssm.params import SSMParams as TP  # noqa: E402


def main() -> int:
    T_, N_ = cs.LGEN_SWEEP_SHAPE
    for k in cs.LGEN_EXACT_KS:
        Ynan, W, _, p = cs.panel(cs.LGEN_SEED + 20 + k, T_=T_, N_=N_, K_=k)
        Y = np.nan_to_num(Ynan)
        pj = JP.from_numpy(p, jnp.float64)
        ll_lr = float(jl.lowrank_filter(jnp.asarray(Y), pj,
                                        mask=jnp.asarray(W), rank=k).loglik)
        ll_info = float(jinf.info_filter(jnp.asarray(Y), pj,
                                         mask=jnp.asarray(W)).loglik)
        pt = TP.from_numpy(p, dtype=torch.float64)
        Yt, Wt = torch.as_tensor(Y), torch.as_tensor(W)
        tl_lr = float(tl.lowrank_filter(Yt, pt, mask=Wt, rank=k).loglik)
        tl_info = float(tinf.info_filter(Yt, pt, mask=Wt).loglik)
        print(json.dumps({
            "k": k, "shape": [T_, N_], "jax_loglik_lowrank": ll_lr,
            "jax_loglik_info": ll_info,
            "jax_rel_gap": abs(ll_lr - ll_info) / abs(ll_info),
            "port_cpu_rel_gap": abs(tl_lr - tl_info) / abs(tl_info)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
