#!/usr/bin/env python3
"""The rank-r fused fit at k = 128 on 480 rows, and a session on it, in
the JAX package and in the port's CPU twins, f32, on the same inputs.

    JAX_PLATFORMS=cpu python3 tools/port/lowrank_diverge.py [N RANKS...]

Defaults: N = 1,500 (the panel's first 1,500 series), ranks 8 and 32.
The panel is the ``lgen`` group's (``chip_smoke.panel`` at k = 128 from
seed 0 + LGEN_SEED + 128, masked), its first ``SESSION_T0`` = 480 rows.
For each package and rank: ``fit(fused=True, max_iters=8, tol=0)`` with
``filter="lowrank"`` in f32 (the JAX package with ``robust=False``), then
``open_session`` on the fit (capacity 1,000, 2 iterations a query, tol =
0) and one update of rows 480-481 with its diffusion-index (DI)
forecast.  Prints one JSON line a (package, rank): whether the fit
diverged and at which iteration (the first loglik that fell), its loglik
trail, and whether the session's nowcast, forecasts and DI forecast are
finite.  No card is needed; a few minutes on the CPU.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import dfm_tpu  # noqa: E402
import dfm_tpu_torch as dtt  # noqa: E402
from dfm_tpu.api import DynamicFactorModel as JModel  # noqa: E402
from dfm_tpu.api import TPUBackend  # noqa: E402
from dfm_tpu.api import fit as jfit  # noqa: E402

ITERS, QUERY_ITERS, CAPACITY = 8, 2, 1000


def first_fall(lls) -> int | None:
    """The first iteration whose loglik is below the one before it."""
    d = np.diff(np.asarray(lls, dtype=np.float64))
    bad = np.flatnonzero(~(d >= 0))
    return int(bad[0]) + 1 if bad.size else None


def finite(x) -> bool:
    return x is not None and bool(np.isfinite(np.asarray(x)).all())


def run(pkg: str, Y, k: int, rank: int) -> dict:
    T0 = cs.SESSION_T0
    kw = dict(fused=True, max_iters=ITERS, tol=0.0)
    skw = dict(capacity=CAPACITY, max_update_rows=8, max_iters=QUERY_ITERS,
               tol=0.0)
    if pkg == "jax":
        jb = TPUBackend(dtype=np.float32, filter="lowrank", rank=rank)
        res = jfit(JModel(k, dynamics="ar1"), Y[:T0], robust=False,
                   backend=jb, **kw)
        sess = dfm_tpu.open_session(res, Y[:T0], robust=False, backend=jb,
                                    **skw)
    else:
        backend = dtt.TorchBackend(device="cpu", dtype=torch.float32,
                                   filter="lowrank", rank=rank)
        res = dtt.fit(dtt.DynamicFactorModel(k, dynamics="ar1"), Y[:T0],
                      backend=backend, **kw)
        sess = dtt.open_session(res, Y[:T0], backend=backend, **skw)
    lls = np.asarray(res.logliks, dtype=np.float64)
    u = sess.update(Y[T0:T0 + 2])
    sess.close()
    return {"package": pkg, "rank": rank, "n_iters": int(res.n_iters),
            "fit_diverged": res.nowcast is None,
            "first_fall_iter": first_fall(lls),
            "logliks": lls.tolist(),
            "session_diverged": bool(u.diverged),
            "nowcast_finite": finite(u.nowcast),
            "forecast_y_finite": finite(u.forecasts["y"]),
            "di_forecast_finite": finite(u.forecasts.get("di")),
            "session_logliks": np.asarray(u.logliks, np.float64).tolist()}


def main(argv: list) -> int:
    N_ = int(argv[0]) if argv else 1500
    ranks = [int(a) for a in argv[1:]] or [8, 32]
    k = cs.LGEN_K
    Ynan = cs.panel(cs.LGEN_SEED + k, K_=k)[0][:, :N_]
    for rank in ranks:
        for pkg in ("jax", "port"):
            rec = run(pkg, Ynan, k, rank)
            print(json.dumps({"N": N_, "k": k, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
