#!/usr/bin/env python3
"""Where an f32 EM fit's loglik drops come from, on one CUDA card.

    python3 tools/port/em_f32_trace.py [--k 100] [--iters 8] [--unmasked]

On ``chip_smoke.py``'s headline panel simulated at k factors (its seed
offset ``KBIG_SEED + k``), standardized, from the device PCA init: ``iters``
EM iterations (``em_fit_scan``, no stop rule) in f64 and in f32 through the
port's kernels, and in f32 through the kernels' plain twins (the wrappers
swapped for their ``*_plain`` functions), and every iterate's params
re-evaluated by the f64 filter (``loglik_eval(precise=True)``).  Prints
the card line and one JSON line: each trajectory's in-loop loglik steps
beside the f64 re-evaluation's, and the f32 noise floor.  An in-loop drop
that the re-evaluation does not make is rounding of the f32 loglik, not of
the params.  Raises without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from dfm_tpu_torch.estim import em as tem  # noqa: E402
from dfm_tpu_torch.estim.init import pca_init_device  # noqa: E402
from dfm_tpu_torch.ops.precision import highest_precision  # noqa: E402
from dfm_tpu_torch.ssm import info_filter as inf  # noqa: E402
from dfm_tpu_torch.ssm import kalman as kal  # noqa: E402
from dfm_tpu_torch.ssm.params import SSMParams  # noqa: E402
from dfm_tpu_torch.utils import data  # noqa: E402


def plain_twins():
    """Swap the info path's kernel wrappers for their plain twins; returns
    the undo."""
    saved = (inf.obs_stats, inf.info_scan, inf.quad_local, tem.rts_smoother,
             tem._mstep_rows_masked)
    inf.obs_stats = inf.obs_stats_plain
    inf.info_scan = inf.info_scan_plain
    inf.quad_local = inf.quad_local_plain
    tem.rts_smoother = kal.rts_smoother_plain
    tem._mstep_rows_masked = tem.mstep_rows_plain

    def undo():
        (inf.obs_stats, inf.info_scan, inf.quad_local, tem.rts_smoother,
         tem._mstep_rows_masked) = saved
    return undo


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--unmasked", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("em_f32_trace needs a CUDA card")
    print(cs.card_line(), flush=True)
    k, masked = args.k, not args.unmasked
    Ynan, W, Yfull, _ = cs.panel(cs.KBIG_SEED + k, K_=k)
    Wm = W if masked else None
    Z, _ = data.standardize(Ynan if masked else Yfull, mask=Wm)
    Z = np.where(np.isfinite(Z), Z, 0.0)
    out = {}
    with highest_precision():
        Z64 = torch.as_tensor(Z, dtype=torch.float64, device="cuda")
        p0 = pca_init_device(Z64, k)
        for label, dtype, plain in (("f64 kernels", torch.float64, False),
                                    ("f32 kernels", torch.float32, False),
                                    ("f32 plain twins", torch.float32, True)):
            Zt = torch.as_tensor(Z, dtype=dtype, device="cuda")
            mt = (torch.as_tensor(W, dtype=dtype, device="cuda")
                  if masked else None)
            pt = SSMParams.from_numpy(p0, dtype=dtype, device="cuda")
            undo = plain_twins() if plain else (lambda: None)
            try:
                ps, lls, _ = tem.em_fit_scan(
                    Zt, pt, args.iters, mask=mt,
                    cfg=tem.EMConfig(filter="info"))
            finally:
                undo()
            lls = lls.cpu().numpy()
            precise = [inf.loglik_eval(Z64, p.to_numpy(), mask=Wm,
                                       precise=True) for p in ps]
            out[label] = {"loglik_0": float(lls[0]),
                          "in_loop_steps": np.diff(lls).tolist(),
                          "f64_reevaluated_steps": np.diff(precise).tolist()}
    print(json.dumps({"em_f32_trace": {"k": k, "masked": masked,
                                       "shape": list(Z.shape)},
                      "noise_floor": tem.noise_floor_for(torch.float32,
                                                         Z.size),
                      **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
