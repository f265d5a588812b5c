#!/usr/bin/env python3
"""A quick check of one family of kernels on one CUDA card, building only
the sources it names.

    python3 tools/port/gen_check.py SOURCES PHASE[:INT...] [PHASE ...]

SOURCES is a comma list of ``dfm_tpu_torch/csrc`` files: only the
kernels, probes and sizing rules of those sources are built (every source,
as ``chip_smoke.py`` builds them, takes ~240 s on an 8-core H100 host).
Each PHASE is a ``chip_smoke`` function, called in order with the seed 0
and the integers after its name.  The families' checks:

    ss and pit past 32 (K5a-gen, K5b-gen, K14-el-gen, K14-scan-gen):
      ss_cov_path.cu,affine_scan.cu,pit_elements.cu,pit_scan.cu
      sgen_k_sweep sgen_kernel_phase:8
    the square-root engine past 10 (qr_elements_gen, qr_scan_gen):
      qr_elements.cu,qr_scan.cu,pit_elements.cu,pit_scan.cu
      qgen_k_sweep [qgen_kernel_phase]
    time-varying loadings past 16 (K2-tv, K1-tv, K11-fwd, K11-bwd):
      obs_stats.cu,quad_local.cu,tv_loadings_gen.cu tgen_k_sweep
    and the rest of the tgen group (the K4 pair and the latency probe):
      obs_stats.cu,quad_local.cu,tv_loadings_gen.cu,info_scan.cu,
      info_scan_gen.cu,step_chain.cu
      tgen_kernel_phase tgen_k_sweep tgen_fit_phase tgen_reference_phase
      tvl_contract_phase:25
    stochastic volatility past 16 and past 1,024 particles (K10-fwd-gen,
    K10-ffbs-gen):
      sv_gen.cu vgen_k_sweep vgen_reference_phase
    (the vgen group's fits, kernel phase and contract also need the
    pre-fit's sources and the latency probe: run ``chip_smoke.py --phases
    vgen``)
    the rank-r engine past k = 100 and r = 32 (K9-basis-gen, K9-fwd-gen,
    K9-bwd-gen) and the dense engine past N = 32 (K15-gen), the sweeps
    and the raises at 129:
      gen_filters.cu lgen_k_sweep dgen_k_sweep
    (the lgen and dgen groups' fits, sessions and references also run the
    generic K1-K4 kernels: ``chip_smoke.py --phases lgen,dgen``)
    the log-depth associative scans (K14-assoc, K8-assoc) at every tier,
    with the blocked kernels beside them and the public functions' path:
      pit_assoc.cu,pit_scan.cu,qr_scan.cu,step_chain.cu,pit_elements.cu,
      qr_elements.cu,obs_stats.cu,quad_local.cu
      assoc_k_sweep assoc_raise_phase assoc_kernel_phase
    (the public functions' phase also runs the K4 pair for the exact
    loglik: add info_scan.cu,info_scan_gen.cu and assoc_public_phase, or
    run ``chip_smoke.py --phases assoc``)

Prints the card line, the build seconds, the sources' ptxas lines and
``chip_smoke``'s JSON records, each phase's seconds.  Raises without a
card, on an unknown source or phase, or on a disagreement.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from dfm_tpu_torch import kernels  # noqa: E402


def main(argv: list) -> int:
    if len(argv) < 2:
        raise SystemExit(__doc__)
    sources = set(argv[0].split(","))
    missing = sorted(s for s in sources if not (kernels.CSRC / s).exists())
    if missing:
        raise SystemExit(f"gen_check: no source {missing} in {kernels.CSRC}")
    if not torch.cuda.is_available():
        raise RuntimeError("gen_check: no CUDA device")
    import chip_smoke as cs

    steps = []
    for arg in argv[1:]:
        name, *ints = arg.split(":")
        fn = getattr(cs, name, None)
        if not callable(fn):
            raise SystemExit(f"gen_check: chip_smoke has no phase {name!r}")
        steps.append((fn, [int(x) for x in ints]))
    for table in (kernels.KERNELS, kernels.PROBES, kernels.QUERIES):
        for name in [n for n, (src, _) in table.items() if src not in sources]:
            del table[name]
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    print(json.dumps({"build_s": kernels.build()}), flush=True)
    for src in sorted(sources):
        for line in kernels.build_log(src).splitlines():
            if "_gen" in line or "built in" in line or "spill" in line:
                print(src, line.strip()[:160])
    for fn, ints in steps:
        t1 = time.perf_counter()
        fn(0, *ints)
        print(json.dumps({"step_s": {"step": fn.__name__,
                                     "s": time.perf_counter() - t1}}),
              flush=True)
    print(json.dumps({"check_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
