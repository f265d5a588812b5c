#!/usr/bin/env python3
"""Cycles of each block-wide routine of the generic K4 pair's linear algebra
(``dfm_tpu_torch/csrc/cta_linalg.cuh``) alone, on one CUDA card.

    python3 tools/port/cta_bench.py

Builds ``tools/port/cta_bench.cu`` with nvcc (plain C entry, ctypes) into
``build/``, then for k = 50, 100 and 128 in f32 and f64 runs one block that
brackets 10 calls of each routine with ``clock64()`` and prints the card
line and one JSON line a (dtype, k): SM cycles a call.  The operands are
random k x k matrices in global memory (an SPD one for the factorization
and the solves).  Raises without a card.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from dfm_tpu_torch import kernels  # noqa: E402

ROUTINES = ("gemm k x k", "gemm k x k, transposed, + D", "gemm k x 32 (64 deep)",
            "sym in place", "sym + jitter", "sym + jitter, potrf",
            "copy", "copy, trsm X L^-T", "copy, trsm X L^-1", "matvec",
            "block barrier", "32 x 32 factor, one warp")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("cta_bench needs a CUDA card")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    lib_path = out_dir / "cta_bench.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                    str(lib_path), str(Path(__file__).with_suffix(".cu"))],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.cta_bench.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                              + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for dtype in (torch.float32, torch.float64):
        for k in (50, 100, 128):
            g = torch.Generator(device="cuda").manual_seed(k)
            A = torch.randn(k, k, device="cuda", dtype=dtype, generator=g)
            B = torch.randn(k, k, device="cuda", dtype=dtype, generator=g)
            S = (A @ A.T + k * torch.eye(k, device="cuda", dtype=dtype))
            C, W, X = (torch.zeros(k, k, device="cuda", dtype=dtype)
                       for _ in range(3))
            out = torch.zeros(len(ROUTINES), dtype=torch.int64,
                              device="cuda")
            for _ in range(2):          # the second run is the warm one
                rc = lib.cta_bench(int(dtype == torch.float64),
                                   A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                   S.contiguous().data_ptr(), W.data_ptr(),
                                   X.data_ptr(), k, out.data_ptr(), 10)
                if rc != 0:
                    raise RuntimeError(f"cta_bench launch failed: {rc}")
                torch.cuda.synchronize()
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""),
                              "k": k, "cycles": dict(zip(ROUTINES,
                                                         out.tolist()))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
