#!/usr/bin/env python3
"""The loglik contract of the rank-r engine in the JAX package at x64 on
the CPU, on the inputs of ``chip_smoke.lowrank_contract_phase``.

    JAX_PLATFORMS=cpu python3 tools/port/lowrank_contract.py [K RANK SEED_OFF]

Defaults: the ``lgen`` group's contract (k = 128, rank 64, the masked
headline panel ``chip_smoke.panel`` simulates from seed 0 + LGEN_SEED +
128).  From the port's f64 PCA init of the standardized panel (computed
here on the CPU), ``dfm_tpu.estim.em.em_fit_scan`` with ``filter="lowrank"``
runs 2 EM updates in f32 and 3 in f64; prints one JSON line: the f64
trajectory's loglik at iteration 3, the f32 2-update params' loglik by the
f64 ``lowrank_filter`` and their relative gap (the figure ROADMAP Queue 3
"Watch" logs when it misses 1e-5), and the f32 trajectory's own. No card
is needed; ~2 min at the defaults.
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
from dfm_tpu.estim import em as jem  # noqa: E402
from dfm_tpu.ssm import lowrank_filter as jl  # noqa: E402
from dfm_tpu.ssm.params import SSMParams as JP  # noqa: E402
from dfm_tpu_torch.estim.init import pca_init_device  # noqa: E402
from dfm_tpu_torch.utils import data  # noqa: E402


def main(argv: list) -> int:
    k, rank, seed_off = (int(a) for a in argv) if argv else (
        cs.LGEN_K, 64, cs.LGEN_SEED + cs.LGEN_K)
    Ynan, W, _, _ = cs.panel(seed_off, K_=k)
    Z, _ = data.standardize(Ynan, mask=W)
    Z = np.where(np.isfinite(Z), Z, 0.0)
    p0 = pca_init_device(torch.as_tensor(Z, dtype=torch.float64), k)
    cfg = jem.EMConfig(filter="lowrank", rank=rank)
    out = {}
    for dt, n in ((jnp.float32, 2), (jnp.float64, 3)):
        p, ll, _ = jem.em_fit_scan(jnp.asarray(Z, dt), JP.from_numpy(p0, dt),
                                   n, mask=jnp.asarray(W, dt), cfg=cfg)
        out[dt] = (p, np.asarray(ll))
    ref = float(out[jnp.float64][1][2])
    p2 = JP(*(jnp.asarray(np.asarray(x), jnp.float64)
              for x in out[jnp.float32][0]))
    precise = float(jl.lowrank_filter(jnp.asarray(Z), p2,
                                      mask=jnp.asarray(W), rank=rank).loglik)
    print(json.dumps({"k": k, "rank": rank, "seed_off": seed_off,
                      "loglik_f64": ref, "loglik_f32_params_f64": precise,
                      "jax_rel_err_precise": abs(precise - ref) / abs(ref),
                      "jax_f32_logliks": out[jnp.float32][1].tolist(),
                      "jax_f64_logliks": out[jnp.float64][1].tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
