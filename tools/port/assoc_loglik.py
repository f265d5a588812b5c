#!/usr/bin/env python3
"""The f32 loglik of the parallel-in-time filters with the log-depth scan
(``scan_impl="associative"``) in the JAX package, against its exact f64
loglik, on the inputs of ``chip_smoke.assoc_public_phase``.

    JAX_PLATFORMS=cpu python3 tools/port/assoc_loglik.py [K ...]

Defaults: k = 10 and 100, the masked headline panel simulated at k
factors (``chip_smoke.assoc_panel``, seed 0) at its true params.  For
each k and engine (``pit``, ``pit_qr``): ``pit_filter`` /
``pit_qr_filter`` in f32 and in f64 with the associative scan, and
``info_filter`` in f64 (the exact loglik); prints one JSON line a (k,
engine) with each loglik and its |loglik - exact| / |exact|.  These are
``chip_smoke.ASSOC_LL_JAX``: the card's f64 loglik is held to the f64
one, and its f32 loglik to the f32 one where that misses 1e-5 of the
exact loglik (ROADMAP Queue 3 "Watch").  Past k = 10 it also
prints the square-root engine's own gap between its two scans in f64,
max|P_f(associative) - P_f(blocked)| / max|P_f(blocked)| from
``pit_qr_from_stats`` (the gap ``chip_smoke.assoc_kernel_phase`` finds
between the twins there).  No card is needed; a few minutes on the CPU,
under 2 GB.
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

import chip_smoke as cs  # noqa: E402
from dfm_tpu.ssm import info_filter as jinf  # noqa: E402
from dfm_tpu.ssm import parallel_filter as jpf  # noqa: E402
from dfm_tpu.ssm.params import SSMParams as JP  # noqa: E402

FILTERS = {"pit": jpf.pit_filter, "pit_qr": jpf.pit_qr_filter}


def main(argv: list) -> int:
    for k in [int(a) for a in argv] or [cs.K, 100]:
        Ynan, W, _, p = cs.assoc_panel(0, k)
        Y = np.where(W > 0, Ynan, 0.0)
        f64 = JP.from_numpy(p, jnp.float64)
        exact = float(jinf.info_filter(jnp.asarray(Y), f64,
                                       mask=jnp.asarray(W)).loglik)
        for engine, fn in FILTERS.items():
            rec = {"k": k, "engine": engine, "loglik_exact_f64": exact}
            for name, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
                ll = float(fn(jnp.asarray(Y, dt), JP.from_numpy(p, dt),
                              mask=jnp.asarray(W, dt),
                              scan_impl="associative").loglik)
                rec[f"loglik_{name}"] = ll
                rec[f"rel_err_{name}"] = abs(ll - exact) / abs(exact)
            print(json.dumps(rec), flush=True)
        if k > 10:
            st = jinf.obs_stats(jnp.asarray(Y), f64.Lam, f64.R,
                                mask=jnp.asarray(W))
            P_f = {impl: np.asarray(jpf.pit_qr_from_stats(st, f64, impl)[3])
                   for impl in ("blocked", "associative")}
            gap = (np.abs(P_f["associative"] - P_f["blocked"]).max()
                   / np.abs(P_f["blocked"]).max())
            print(json.dumps({"k": k, "engine": "pit_qr",
                              "scan_gap_P_f_f64": float(gap)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
