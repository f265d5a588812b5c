#!/usr/bin/env python3
"""A quick check of the square-root engine's generic kernels past k = 10
(qr_elements_gen, qr_scan_gen) on one CUDA card, building only their
sources.

    python3 tools/port/qr_gen_check.py [--time]

Builds the square-root engine's sources (``qr_elements.cu``,
``qr_scan.cu`` and ``pit_elements.cu``, ``pit_scan.cu``, which hold the
generic kernels; not every source, as ``chip_smoke.py`` does), prints the
generic kernels' ptxas lines, then runs ``chip_smoke.qgen_k_sweep``: every mode
of both kernels (the filter and smoother elements, both assemblies, the
prefix and the suffix, the six unit ops) against its plain twin through
the wrappers at k = 10 (the one-thread kernels) and 11, 16, 25, 32, 33,
64, 128 (the generic ones) on 97 x 300 panels, f64 then f32, and the
raise at k = 129 before any launch.  With ``--time`` it also runs
``chip_smoke.qgen_kernel_phase``: each mode timed at (T, N) = (500,
10,000), k = 25, 50 and 100, and on S3's augmented state in f64.  Prints
the card line and ``chip_smoke``'s JSON records.  Raises without a card or
on a disagreement.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from dfm_tpu_torch import kernels  # noqa: E402

SOURCES = {"qr_elements.cu", "qr_scan.cu", "pit_elements.cu", "pit_scan.cu"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("qr_gen_check: no CUDA device")
    for name in list(kernels.KERNELS):
        if kernels.KERNELS[name][0] not in SOURCES:
            del kernels.KERNELS[name]
    kernels.PROBES.clear()
    t0 = time.perf_counter()
    print(json.dumps({"build_s": kernels.build()}), flush=True)
    for src in sorted(SOURCES):
        for line in kernels.build_log(src).splitlines():
            if "_gen" in line or "built in" in line:
                print(src, line.strip()[:160])

    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    cs.qgen_k_sweep(0)
    if args.time:
        cs.qgen_kernel_phase(0)
    print(json.dumps({"check_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
