"""Build and load layer for the port's hand-written CUDA kernels.

At first use each ``csrc/*.cu`` source is compiled by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface, under ``build/dfm_tpu_torch/`` beside the package and named by a
hash of the sources' contents and the flags, so an edited source rebuilds
and an unchanged one is reused.  The libraries are loaded with ``ctypes``;
every pointer and the stream cross as ``c_void_p`` (a default ctypes int
would cut a pointer to 32 bits).

Each C entry point launches on the current PyTorch stream and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0, and counts
the launch in ``LAUNCHES`` (one plain integer per kernel) only when it
went through.  Nothing here falls back: a missing ``nvcc``, a failed build
or a failed launch raises.

``PROBES`` are measurement kernels that no model path runs (the latency
floor of K4, ``csrc/step_chain.cu``); ``probe`` launches one without
counting it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "KERNELS", "PROBES", "build", "launch", "probe",
           "reset_launches", "check_k", "check_tensor"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dfm_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
KMAX = 16   # DFM_KMAX in csrc/common.cuh

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double

# kernel -> (source, C argument types before the trailing stream).  Each
# kernel exports ``<name>_f32`` and ``<name>_f64``.
KERNELS = {
    "quad_local": ("quad_local.cu", [_P] * 6 + [_I] * 3),
    "obs_stats": ("obs_stats.cu", [_P] * 8 + [_I] * 3),
    "mstep_rows": ("mstep_rows.cu", [_P] * 7 + [_I] * 3 + [_D] * 2),
    "info_scan": ("info_scan.cu", [_P, _P, _I] + [_P] * 9 + [_I] * 2),
    "rts_smoother": ("info_scan.cu", [_P] * 8 + [_I] * 2),
}

# Measurement kernels off the model path, in the same form.
PROBES = {
    "step_chain": ("step_chain.cu", [_P, _P] + [_I] * 3),
}

LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                       "dfm_tpu_torch CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every kernel source not yet built, one ``nvcc`` per source,
    all in parallel.  Returns the wall seconds spent; raises on failure."""
    t0 = time.perf_counter()
    todo = {}
    for source, _ in (*KERNELS.values(), *PROBES.values()):
        out = _lib_path(source)
        if not out.exists():
            todo[source] = out
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for source, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            procs[source] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for source, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{source}:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def _lib(source: str):
    lib = _LIBS.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for name, (src, argtypes) in (*KERNELS.items(), *PROBES.items()):
            if src != source:
                continue
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = argtypes + [_P]
                fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def check_k(name: str, k: int) -> None:
    """Raise unless the factor count is one the kernels take."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"{name} kernel takes 1 <= k <= {KMAX}; got k = {k}")


def check_tensor(name: str, x, shape, dtype, device) -> None:
    """Raise unless ``x`` is a contiguous tensor of this shape, dtype and
    device (what the kernels take)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _call(table: dict, name: str, dtype: torch.dtype, args) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: no kernel for dtype {dtype}")
    source = table[name][0]
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(_lib(source), f"{name}_{suffix}")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    rc = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name}_{suffix} failed to launch: "
                           f"cudaError {rc}")


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Launch kernel ``name`` in ``dtype`` on the current CUDA stream.

    ``args`` are the C arguments before the stream: tensors (passed by
    their data pointer; the caller keeps them alive), ``None`` for a null
    pointer, and Python ints and floats.
    """
    _call(KERNELS, name, dtype, args)
    LAUNCHES[name] += 1


def probe(name: str, dtype: torch.dtype, *args) -> None:
    """Launch measurement kernel ``name`` (``PROBES``) as ``launch`` does,
    without counting it."""
    _call(PROBES, name, dtype, args)
