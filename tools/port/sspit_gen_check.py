#!/usr/bin/env python3
"""A quick check of the generic ss and pit kernels (K5a-gen, K5b-gen,
K14-el-gen, K14-scan-gen) on one CUDA card, building only their sources.

    python3 tools/port/sspit_gen_check.py

Builds ``ss_cov_path.cu``, ``affine_scan.cu``, ``pit_elements.cu`` and
``pit_scan.cu`` (not every source, as ``chip_smoke.py`` does: ~100 s
instead of ~200), prints their ptxas lines, then holds each kernel against
its plain twin through the wrappers at k = 33, 50, 100, 128 on 97 x 300
panels (step 0 fully missing, a step observing fewer than k series, a
never-observed series; K14 with a per-step and with a static C, K5a at tau
= 8 and 24), f64 then f32, with ``chip_smoke.py``'s ``compare`` (the TOL
rule), and times each at (T, N) = (500, 10,000), k = 50 and 100, f32 (CUDA
events, warm L2; K5a at tau = 48).  Prints the card line and one JSON line
a sweep point and a timed k.  Raises without a card or on a disagreement.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from dfm_tpu_torch import kernels  # noqa: E402

SOURCES = {"ss_cov_path.cu", "affine_scan.cu", "pit_elements.cu",
           "pit_scan.cu"}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("sspit_gen_check: no CUDA device")
    for name in list(kernels.KERNELS):
        if kernels.KERNELS[name][0] not in SOURCES:
            del kernels.KERNELS[name]
    kernels.PROBES.clear()
    t0 = time.perf_counter()
    print(json.dumps({"build_s": kernels.build()}), flush=True)
    for src in sorted(SOURCES):
        for line in kernels.build_log(src).splitlines():
            if "_gen" in line or "built in" in line or "spill" in line:
                print(src, line.strip()[:160])

    import chip_smoke as cs
    from dfm_tpu_torch.ops import scan as sc
    from dfm_tpu_torch.ops.precision import highest_precision
    from dfm_tpu_torch.ssm import steady as ss

    print(cs.card_line(), flush=True)
    T_, N_ = cs.SGEN_SWEEP_SHAPE
    taus = [(f"tau={t}", t) for t in cs.SGEN_SWEEP_TAUS]
    for k in cs.SGEN_SWEEP:
        _, W, Yfull, p = cs.panel(7 + k, T_=T_, N_=N_, K_=k)
        W[0] = 0.0
        W[7] = 0.0
        W[7, :k - 1] = 1.0
        W[:, 3] = 0.0
        Ynan = cs.np.where(W > 0, Yfull, cs.np.nan)
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                stats, ustats, pt = cs.sgen_stats(Ynan, W, Yfull, p, dtype)
                for c in cs.sgen_cases(stats, ustats, pt, taus, "masked",
                                       static=ustats):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = cs.compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    worst[f"{c['variant']} {str(dtype)[6:]}"] = rel
        print(json.dumps({"k": k, "max_rel_err": worst,
                          "launches": {n: v for n, v in
                                       kernels.LAUNCHES.items() if v}}),
              flush=True)
        kernels.reset_launches()
    for k in (50, 100):
        pan = cs.panel(11 + k, K_=k)
        with highest_precision():
            stats, ustats, pt = cs.sgen_stats(*pan, torch.float32)
            ms = {c["variant"]: cs.cuda_ms(c["run"])
                  for c in cs.pit_cases(stats, pt, "masked")}
            _, fwd, rev = cs.ss_inputs(ustats, pt, 48)
            ms["ss_cov_path tau=48"] = cs.cuda_ms(
                lambda: ss.ss_cov_path(ustats.C, pt.A, pt.Q, pt.P0, 48))
            ms["affine forward"] = cs.cuda_ms(lambda: sc.affine_scan(*fwd))
            ms["affine reverse"] = cs.cuda_ms(
                lambda: sc.affine_scan(*rev, reverse=True))
        print(json.dumps({"k": k, "T": cs.T, "N": cs.N, "dtype": "float32",
                          "kernel_ms": ms}), flush=True)
    print(json.dumps({"total_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
