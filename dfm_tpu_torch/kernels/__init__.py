"""Build and load layer for the port's hand-written CUDA kernels.

At first use each ``csrc/*.cu`` source is compiled twice, once per dtype
(``-DDFM_DTYPE=32`` and ``64``: each library holds one dtype's entry
points, so the two halves of a heavy source build in parallel), by its own
``nvcc`` processes (``build_start`` queues them all, a caller's sources
first, and runs them in the background, one fewer at a time than the
host has cores, each at the lowest CPU priority (``nice``), so the
caller's own work beside the build takes a core whenever it runs;
``build`` waits for all, and a kernel's first launch for its own library)
into shared libraries with a plain C interface, under
``build/dfm_tpu_torch/`` beside the package and named by a hash of the sources' contents and the flags, so an edited
source rebuilds and an unchanged one is reused.  The libraries are loaded with ``ctypes``;
every pointer and the stream cross as ``c_void_p`` (a default ctypes int
would cut a pointer to 32 bits).

nvcc runs with ``-Xptxas -v``; each library's compiler output (registers,
stack frames and spills of every instantiation) and its build seconds go
to a ``.log`` beside it, which ``build_log`` returns.

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

import atexit
import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "KERNELS", "PROBES", "build", "build_start",
           "build_pending", "build_log", "launch", "probe", "reset_launches",
           "check_k", "check_lowrank", "check_dense", "route_lowrank",
           "route_dense", "route_sv",
           "check_tensor", "WIDE", "GEN",
           "DEVICE_LAUNCHES", "route", "gen_ctas", "GEN_MATS", "QUERIES",
           "query"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dfm_tpu_torch"
# nvcc's -O is the host compiler's level: the host side is the C entry
# points, which only launch, so -O0 (device code is optimized regardless;
# a build of every source took 221 s on an 8-core H100 host, 242-260 s at
# -O3).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KMAX = 16   # DFM_KMAX in csrc/common.cuh
# The wide kernels' range (DFM_WIDE_KMAX): K12, the lone masked K2, the K4
# pair and K1 at state widths past KMAX (the mixed-frequency augmented
# state, m = 25 at S3), K3, K5a and K5b past KMAX (the lone fits at 16 <
# k <= 32), the batched twins K4b, K1b, K6b, K2b-m, K1b-m and K3b-m past
# KMAX (fit_many, the k-grid, the rolling windows and fleet buckets at
# 16 < k <= 32), K2-tv and K1-tv past KMAX (the time-varying-loadings
# family at 16 < k <= 32; K11 takes its generic kernels there), K14
# (pit_elements, pit_scan, pit_assoc: one kernel each at every k <= 32),
# and K15 (dense_filter) at every N and k.
WIDE_KMAX = 32
# The generic kernels' range (DFM_GEN_KMAX): the lone K2 (masked), the K4
# pair, K1 (quad_local and loglik_terms_local), K3 (masked), K5a and K5b
# (ss_cov_path, affine_scan) and K14 (pit_elements, pit_scan, pit_assoc)
# at 32 < k <= 128, each with a runtime k (the lone info, ss, pit and
# lowrank fits, fused fits and sessions past 32, the mixed-frequency seq and pit routes
# at m > 32), and the batched twins K4b (both passes), K1b, K6b, K2b-m,
# K1b-m and K3b-m there (fit_many, the k-grid, the rolling windows and
# info and lowrank fleet buckets past 32), and the time-varying-loadings
# family's K2-tv, K1-tv, K11-fwd and K11-bwd there (K11's generic kernels
# from KMAX up), and the stochastic-volatility family's K10-fwd and
# K10-ffbs (their generic kernels from KMAX up, and at any k past SV_MMAX
# particles: ``route_sv``).  The square-root engine's K8 (qr_elements_gen,
# qr_scan_gen) and K8-assoc (qr_assoc_gen) take 10 < k <= GEN_KMAX; the
# rank-r trio K9 and the dense filter K15 take their generic kernels (``csrc/gen_filters.cu``) past
# their own kernels' ranges (below) to k = GEN_KMAX, r <= k and N =
# GEN_KMAX (``route_lowrank``, ``route_dense``).
GEN_KMAX = 128
# The rank-r kernels' range (DFM_LR_KMAX, DFM_LR_RMAX in lowrank_scan.cu);
# past either, to k = GEN_KMAX and any r <= k, their generic kernels.
LOWRANK_KMAX, LOWRANK_RMAX = 100, 32
# The ROADMAP row that ports the kernels past their k range.
GENERIC_K = "ROADMAP Queue 2, 'Generic k, the kernels already ported'"
# K10's own kernels' particle range (DFM_SV_MMAX in sv_rbpf.cu: their step
# kernel is one block, a particle a thread; past it ``route_sv`` gives the
# generic kernels, which take any M) and their residual stage's series tile
# (SV_TILE there), which sizes the per-tile partials the wrapper allocates.
SV_MMAX, SV_TILE = 1024, 64

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double

# kernel -> (source, C argument types before the trailing stream).  Each
# kernel exports ``<name>_f32`` and ``<name>_f64``.
KERNELS = {
    "quad_local": ("quad_local.cu", [_P] * 6 + [_I] * 3),
    "obs_stats": ("obs_stats.cu", [_P] * 8 + [_I] * 3),
    "mstep_rows": ("mstep_rows.cu", [_P] * 7 + [_I] * 3 + [_D] * 2),
    "info_scan": ("info_scan.cu", [_P, _P, _I] + [_P] * 9 + [_I] * 2),
    "rts_smoother": ("info_scan.cu", [_P] * 8 + [_I] * 2),
    "ss_cov_path": ("ss_cov_path.cu", [_P] * 12 + [_I] * 2),
    "affine_scan": ("affine_scan.cu", [_P] * 5 + [_I] * 4),
    "qr_elements": ("qr_elements.cu", [_I] * 2 + [_P] * 12 + [_I] * 3),
    "qr_scan": ("qr_scan.cu", [_I] + [_P] * 6 + [_I] * 3),
    "ring_append": ("ring_append.cu", [_P] * 4 + [_I] * 5),
    "batched_info_scan": ("info_scan.cu",
                          [_P, _P, _I, _I] + [_P] * 10 + [_I] * 3),
    "batched_rts": ("info_scan.cu", [_P] * 8 + [_I] * 3),
    "batched_quad": ("quad_local.cu", [_P] * 8 + [_I] * 4),
    "batched_solve_rows": ("bsolve_rows.cu", [_P] * 3 + [_I] * 3),
    "batched_ring_append": ("ring_append.cu", [_P] * 6 + [_I] * 4),
    "batched_obs_stats": ("obs_stats.cu", [_P] * 8 + [_I] * 4),
    "batched_quad_masked": ("quad_local.cu", [_P] * 9 + [_I] * 4),
    "batched_mstep_rows": ("mstep_rows.cu", [_P] * 7 + [_I] * 4 + [_D]),
    "lowrank_basis": ("lowrank_scan.cu", [_P] * 2 + [_I] * 3),
    "lowrank_scan": ("lowrank_scan.cu", [_P, _P, _I, _I] + [_P] * 11
                     + [_I] * 4),
    "lowrank_smoother": ("lowrank_scan.cu", [_P] * 10 + [_I] * 4),
    "tvl_obs_stats": ("obs_stats.cu", [_P] * 8 + [_I] * 3),
    "tvl_quad": ("quad_local.cu", [_P] * 7 + [_I] * 3),
    "loading_filter": ("tv_loadings.cu", [_P] * 8 + [_I] * 3),
    "loading_smoother": ("tv_smoother.cu", [_P] * 6 + [_I] * 3),
    "obs_stats_wide": ("obs_stats.cu", [_P] * 8 + [_I] * 3),
    "info_scan_wide": ("info_scan.cu", [_P, _P, _I] + [_P] * 9 + [_I] * 2),
    "rts_smoother_wide": ("info_scan.cu", [_P] * 8 + [_I] * 2),
    "quad_local_wide": ("quad_local.cu", [_P] * 7 + [_I] * 3),
    "sv_rbpf": ("sv_rbpf.cu", [_P] * 23 + [_I] * 5 + [_D] * 2),
    "sv_ffbs": ("sv_rbpf.cu", [_P] * 6 + [_I] * 4),
    "pit_elements": ("pit_elements.cu", [_I] + [_P] * 12 + [_I] * 3),
    "pit_scan": ("pit_scan.cu", [_I] + [_P] * 6 + [_I] * 3),
    "dense_filter": ("dense_filter.cu", [_P] * 13 + [_I] * 3),
    "mstep_rows_wide": ("mstep_rows.cu", [_P] * 7 + [_I] * 3 + [_D] * 2),
    "ss_cov_path_wide": ("ss_cov_path.cu", [_P] * 12 + [_I] * 2),
    "affine_scan_wide": ("affine_scan.cu", [_P] * 5 + [_I] * 4),
    "batched_info_scan_wide": ("info_scan.cu",
                               [_P, _P, _I, _I] + [_P] * 10 + [_I] * 3),
    "batched_rts_wide": ("info_scan.cu", [_P] * 8 + [_I] * 3),
    "batched_quad_wide": ("quad_local.cu", [_P] * 8 + [_I] * 4),
    "batched_quad_masked_wide": ("quad_local.cu", [_P] * 9 + [_I] * 4),
    "batched_solve_rows_wide": ("bsolve_rows.cu", [_P] * 3 + [_I] * 3),
    "batched_obs_stats_wide": ("obs_stats.cu", [_P] * 8 + [_I] * 4),
    "batched_mstep_rows_wide": ("mstep_rows.cu",
                                [_P] * 7 + [_I] * 4 + [_D]),
    "obs_stats_gen": ("obs_stats.cu", [_P] * 8 + [_I] * 3),
    "info_scan_gen": ("info_scan_gen.cu",
                      [_P, _P, _I] + [_P] * 10 + [_I] * 2),
    "rts_smoother_gen": ("info_scan_gen.cu", [_P] * 9 + [_I] * 2),
    "quad_local_gen": ("quad_local.cu", [_P] * 7 + [_I] * 3),
    "mstep_rows_gen": ("mstep_rows.cu", [_P] * 7 + [_I] * 3 + [_D] * 2),
    "batched_info_scan_gen": ("info_scan_gen.cu",
                              [_P, _P, _I, _I] + [_P] * 11 + [_I] * 3),
    "batched_rts_gen": ("info_scan_gen.cu", [_P] * 9 + [_I] * 3),
    "batched_quad_gen": ("quad_local.cu", [_P] * 8 + [_I] * 4),
    "batched_quad_masked_gen": ("quad_local.cu", [_P] * 9 + [_I] * 4),
    "batched_solve_rows_gen": ("bsolve_rows.cu", [_P] * 4 + [_I] * 3),
    "batched_obs_stats_gen": ("obs_stats.cu", [_P] * 8 + [_I] * 4),
    "batched_mstep_rows_gen": ("mstep_rows.cu", [_P] * 7 + [_I] * 4 + [_D]),
    "ss_cov_path_gen": ("ss_cov_path.cu", [_P] * 13 + [_I] * 2),
    "affine_scan_gen": ("affine_scan.cu", [_P] * 5 + [_I] * 4),
    "pit_elements_gen": ("pit_elements.cu", [_I] + [_P] * 13 + [_I] * 4),
    "pit_scan_gen": ("pit_scan.cu", [_I] + [_P] * 7 + [_I] * 4),
    "qr_elements_gen": ("pit_elements.cu", [_I] * 2 + [_P] * 13 + [_I] * 4),
    "qr_scan_gen": ("pit_scan.cu", [_I] + [_P] * 7 + [_I] * 4),
    "tvl_obs_stats_wide": ("obs_stats.cu", [_P] * 8 + [_I] * 3),
    "tvl_obs_stats_gen": ("obs_stats.cu", [_P] * 8 + [_I] * 3),
    "tvl_quad_wide": ("quad_local.cu", [_P] * 7 + [_I] * 3),
    "tvl_quad_gen": ("quad_local.cu", [_P] * 7 + [_I] * 3),
    "loading_filter_gen": ("tv_loadings_gen.cu", [_P] * 8 + [_I] * 3),
    "loading_smoother_gen": ("tv_loadings_gen.cu", [_P] * 7 + [_I] * 4),
    "sv_rbpf_gen": ("sv_gen.cu", [_P] * 26 + [_I] * 7 + [_D] * 2),
    "sv_ffbs_gen": ("sv_gen.cu", [_P] * 6 + [_I] * 4),
    "lowrank_basis_gen": ("gen_filters.cu", [_P] * 3 + [_I] * 3),
    "lowrank_scan_gen": ("gen_filters.cu", [_P, _P, _I, _I] + [_P] * 12
                         + [_I] * 4),
    "lowrank_smoother_gen": ("gen_filters.cu", [_P] * 10 + [_I] * 4),
    "dense_filter_gen": ("gen_filters.cu", [_P] * 14 + [_I] * 3),
    "pit_assoc": ("pit_assoc.cu", [_I] + [_P] * 6 + [_I] * 2),
    "pit_assoc_gen": ("pit_assoc.cu", [_I] + [_P] * 7 + [_I] * 3),
    "qr_assoc": ("pit_assoc.cu", [_I] + [_P] * 6 + [_I] * 2),
    "qr_assoc_gen": ("pit_assoc.cu", [_I] + [_P] * 7 + [_I] * 3),
}

# The entry points with a wide kernel beside the k <= KMAX one, and its
# name (each batched twin's wide kernel takes its C arguments; so do K2-tv's
# and K1-tv's).  K11's one kernel past KMAX (``loading_filter_gen``,
# ``loading_smoother_gen``) and K10's (``sv_rbpf_gen``, ``sv_ffbs_gen``;
# ``route_sv``) serve this tier and the generic one.  Every other kernel
# stops at KMAX.
WIDE = {"obs_stats": "obs_stats_wide", "info_scan": "info_scan_wide",
        "rts_smoother": "rts_smoother_wide", "quad_local": "quad_local_wide",
        "mstep_rows": "mstep_rows_wide", "ss_cov_path": "ss_cov_path_wide",
        "affine_scan": "affine_scan_wide",
        "batched_info_scan": "batched_info_scan_wide",
        "batched_rts": "batched_rts_wide",
        "batched_quad": "batched_quad_wide",
        "batched_quad_masked": "batched_quad_masked_wide",
        "batched_solve_rows": "batched_solve_rows_wide",
        "batched_obs_stats": "batched_obs_stats_wide",
        "batched_mstep_rows": "batched_mstep_rows_wide",
        "tvl_obs_stats": "tvl_obs_stats_wide", "tvl_quad": "tvl_quad_wide",
        "loading_filter": "loading_filter_gen",
        "loading_smoother": "loading_smoother_gen",
        "sv_rbpf": "sv_rbpf_gen", "sv_ffbs": "sv_ffbs_gen"}

# The entry points with a generic kernel for WIDE_KMAX < k <= GEN_KMAX, and
# its name.  obs_stats, quad_local and mstep_rows, affine_scan and the
# batched quad, quad_masked, obs_stats and mstep_rows take their wide
# kernel's C arguments; info_scan and rts_smoother take one more, a (4, k,
# k) workspace the wrapper allocates, their batched twins a (B, 4, k, k)
# one, batched_solve_rows a (B, k, k) one (the lanes' factors) and
# ss_cov_path a (5, k, k) one; pit_elements and pit_scan take a workspace
# of GEN_MATS k x k matrices a CTA and, last, the CTA count of their
# persistent grids (``gen_ctas``).  tvl_obs_stats and tvl_quad take their
# k <= KMAX kernel's C arguments; loading_smoother_gen takes a workspace
# (null where a series' matrices fit in shared memory) and, last, its
# slot count (models/tv_loadings.py).  sv_rbpf_gen takes its own scratch
# (the state, the double-buffered P_f, the int state, the residual
# partials, the prediction's workspace; models/sv.py) and the series of a
# residual chunk and the workspace slots, which its sizing rules give;
# sv_ffbs_gen takes sv_ffbs's arguments.
GEN = {"obs_stats": "obs_stats_gen", "info_scan": "info_scan_gen",
       "rts_smoother": "rts_smoother_gen", "quad_local": "quad_local_gen",
       "mstep_rows": "mstep_rows_gen",
       "ss_cov_path": "ss_cov_path_gen", "affine_scan": "affine_scan_gen",
       "pit_elements": "pit_elements_gen", "pit_scan": "pit_scan_gen",
       "pit_assoc": "pit_assoc_gen",
       "batched_info_scan": "batched_info_scan_gen",
       "batched_rts": "batched_rts_gen", "batched_quad": "batched_quad_gen",
       "batched_quad_masked": "batched_quad_masked_gen",
       "batched_solve_rows": "batched_solve_rows_gen",
       "batched_obs_stats": "batched_obs_stats_gen",
       "batched_mstep_rows": "batched_mstep_rows_gen",
       "tvl_obs_stats": "tvl_obs_stats_gen", "tvl_quad": "tvl_quad_gen",
       "loading_filter": "loading_filter_gen",
       "loading_smoother": "loading_smoother_gen",
       "sv_rbpf": "sv_rbpf_gen", "sv_ffbs": "sv_ffbs_gen"}
# k x k workspace matrices a CTA of the generic kernels on persistent
# grids: pit_elements_gen and pit_scan_gen (the last template argument of
# PegCta in pit_elements.cu, of GenCta in pit_combine.cuh), qr_elements_gen
# and qr_scan_gen (QR_EL_MATS in pit_elements.cu, QR_SCAN_MATS in
# pit_combine.cuh: beside the pit engine's generic kernels, whose
# block-wide routines they share, so those compile once a dtype), and the
# log-depth scans' pit_assoc_gen and qr_assoc_gen (pit_assoc.cu: the same
# combine bodies, so GenCta's and QR_SCAN_MATS).
# The square-root engine's kernels are routed by ops.linalg.check_qr_k
# (their own to k = 10, the generic ones to GEN_KMAX), not by ``route``.
GEN_MATS = {"pit_elements_gen": 4, "pit_scan_gen": 6, "qr_elements_gen": 8,
            "qr_scan_gen": 10, "pit_assoc_gen": 6, "qr_assoc_gen": 10}

# The kernels whose one C call launches more than one device kernel, and
# how many: ``launch`` counts each.  K6b-gen factors the lanes' S, then
# solves the row tiles against the factors; K5a-gen runs the covariance
# steps, the gains (a CTA a step) and the smoothed covariances.  (K14-scan
# and K8-gen's scan count one a pass at every k: their four phase kernels
# are one scan.)
DEVICE_LAUNCHES = {"batched_solve_rows_gen": 2, "ss_cov_path_gen": 3}

# Measurement kernels off the model path, in the same form.
PROBES = {
    "step_chain": ("step_chain.cu", [_P, _P] + [_I] * 3),
}

# Host-side sizing rules a wrapper asks before it allocates a kernel's
# buffers, kept beside the launcher they size: name -> (source, C argument
# types; no stream).  Each exports ``<name>_f32`` and ``<name>_f64`` and
# returns an int.
QUERIES = {
    "loading_smoother_gen_slots": ("tv_loadings_gen.cu", [_I] * 3),
    "sv_rbpf_gen_series": ("sv_gen.cu", [_I] * 3),
    "sv_rbpf_gen_slots": ("sv_gen.cu", [_I] * 3),
    "lowrank_gen_work": ("gen_filters.cu", [_I] * 3),
    "dense_gen_work": ("gen_filters.cu", [_I] * 2),
}

LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict = {}
_SUFFIXES = ("f32", "f64")


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


def _flags(suffix: str) -> list:
    return NVCC_FLAGS + [f"-DDFM_DTYPE={suffix[1:]}"]


def _lib_path(source: str, suffix: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_flags(suffix)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{suffix}-{h.hexdigest()[:16]}.so"


class _Job:
    """One library's compile: its path, and ``done`` set when nvcc ended
    (``error`` its log if it failed)."""

    def __init__(self, out: Path):
        self.out = out
        self.done = threading.Event()
        self.error = None


_JOBS: dict = {}        # (source, suffix) -> _Job of this process
_QUEUE: list = []       # keys not started yet, in compile order
_RUNNING: dict = {}     # key -> (Popen, tmp path, start seconds)
_LOCK = threading.Lock()
_STOPPED = False
_THREAD = None          # the thread that runs the queue, while it does


def _sources(first=()) -> list:
    """Every source of the tables, ``first``'s in their order first."""
    out = list(first)
    for source, _ in (*KERNELS.values(), *PROBES.values()):
        if source not in out:
            out.append(source)
    return out


def build_start(first=()) -> None:
    """Start compiling, in the background, every kernel library not yet
    built: one ``nvcc`` per source and dtype, at most ``os.cpu_count() -
    1`` at a time, niced (``_start``: a caller's own threads take a core
    whenever they run), the sources in ``first`` first, then the rest in
    table order.  Returns at once; ``_lib`` waits for its own library
    (moving it to the front of the queue if it has not started) and
    ``build`` for all.  The compiles still
    running when the interpreter exits are killed."""
    global _THREAD
    todo = []
    with _LOCK:
        for source in _sources(first):
            for suffix in _SUFFIXES:
                out = _lib_path(source, suffix)
                if (source, suffix) not in _JOBS and not out.exists():
                    todo.append((source, suffix, out))
        if not todo:
            return
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for source, suffix, out in todo:
            _JOBS[(source, suffix)] = _Job(out)
            _QUEUE.append((source, suffix))
        if _THREAD is None:
            _THREAD = threading.Thread(target=_run_queue, daemon=True,
                                       args=(nvcc, time.perf_counter()))
            _THREAD.start()


def _run_queue(nvcc: str, t0: float) -> None:
    """The build thread: keeps up to ``os.cpu_count() - 1`` compiles
    running until the queue is empty.  A job it cannot start or finish
    (no file handle, a full disk) ends with that error, and so does every
    job still waiting if the thread itself fails, so no caller of ``_wait``
    is left waiting."""
    global _THREAD
    width = max(1, (os.cpu_count() or 2) - 1)
    try:
        while True:
            with _LOCK:
                if _STOPPED or (not _QUEUE and not _RUNNING):
                    _THREAD = None
                    return
                while _QUEUE and len(_RUNNING) < width:
                    key = _QUEUE.pop(0)
                    try:
                        _RUNNING[key] = _start(nvcc, key)
                    except Exception as e:
                        _fail(key, e)
                ended = [(key, *run) for key, run in _RUNNING.items()
                         if run[0].poll() is not None]
                for key, *_ in ended:
                    del _RUNNING[key]
            for key, proc, tmp, began in ended:
                try:
                    _finish(key, proc, tmp, began, t0)
                except Exception as e:
                    _fail(key, e)
                _JOBS[key].done.set()
            time.sleep(0.05)
    except BaseException as e:
        with _LOCK:
            _THREAD = None
            left = [*_QUEUE, *_RUNNING]
            _QUEUE.clear()
        for key in left:
            _fail(key, e)
        raise


def _start(nvcc: str, key):
    """Start ``key``'s nvcc under ``nice -n 19`` (it and the compilers it
    runs take the CPU only when this process's threads leave it idle),
    its output to the library's log: (the process, its temporary output,
    its start seconds)."""
    job = _JOBS[key]
    tmp = job.out.with_suffix(f".{os.getpid()}.tmp")
    nice = shutil.which("nice")
    cmd = ([nice, "-n", "19"] if nice else []) + [
        nvcc, *_flags(key[1]), "-o", str(tmp), str(CSRC / key[0])]
    with open(job.out.with_suffix(".log"), "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return proc, tmp, time.perf_counter()


def _finish(key, proc, tmp, began: float, t0: float) -> None:
    """Record ``key``'s ended compile: its log as the job's error if nvcc
    failed, else the seconds appended to the log and the library moved
    into place."""
    job = _JOBS[key]
    log = job.out.with_suffix(".log")
    now = time.perf_counter()
    if proc.returncode != 0:
        job.error = f"{key[0]} ({key[1]}):\n{log.read_text()}"
    else:
        with open(log, "a") as fh:
            fh.write(f"# built in {now - t0:.1f} s (nvcc "
                     f"{now - began:.1f} s)\n")
        os.replace(tmp, job.out)


def _fail(key, err: BaseException) -> None:
    """End ``key``'s job with ``err`` (``_wait`` raises it)."""
    job = _JOBS[key]
    job.error = f"{key[0]} ({key[1]}): {type(err).__name__}: {err}"
    job.done.set()


@atexit.register
def _stop_builds() -> None:
    global _STOPPED
    with _LOCK:
        _STOPPED = True
        _QUEUE.clear()
        running = list(_RUNNING.values())
    for proc, *_ in running:        # nvcc and the tools it runs
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _wait(keys) -> None:
    errors = []
    for key in keys:
        job = _JOBS.get(key)
        if job is None:
            continue
        with _LOCK:
            if key in _QUEUE:
                _QUEUE.remove(key)
                _QUEUE.insert(0, key)
        job.done.wait()
        if job.error:
            errors.append(job.error)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build_pending() -> int:
    """Libraries queued or compiling in this process."""
    with _LOCK:
        return len(_QUEUE) + len(_RUNNING)


def build() -> float:
    """Compile every kernel library not yet built (``build_start``) and
    wait for all of them.  Returns the wall seconds spent here; raises on
    a failed compile."""
    t0 = time.perf_counter()
    build_start()
    _wait(list(_JOBS))
    return time.perf_counter() - t0


def build_log(source: str) -> str:
    """nvcc's output (``-Xptxas -v``) for the built libraries of
    ``source``, each ending in its build seconds; empty if never built
    here."""
    logs = (_lib_path(source, suffix).with_suffix(".log")
            for suffix in _SUFFIXES)
    return "".join(log.read_text() for log in logs if log.exists())


def _lib(source: str, suffix: str):
    lib = _LIBS.get((source, suffix))
    if lib is None:
        path = _lib_path(source, suffix)
        if not path.exists():
            build_start()
            _wait([(source, suffix)])
        lib = ctypes.CDLL(str(path))
        for name, (src, argtypes) in (*KERNELS.items(), *PROBES.items()):
            if src == source:
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = argtypes + [_P]
                fn.restype = ctypes.c_int
        for name, (src, argtypes) in QUERIES.items():
            if src == source:
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[(source, suffix)] = lib
    return lib


def check_k(name: str, k: int, kmax: int = KMAX) -> None:
    """Raise unless the factor count is one the kernel takes: k < 1 is
    an error, k > kmax (KMAX; WIDE_KMAX for the wide kernels, GEN_KMAX for
    the generic ones) not ported yet (the plain twins take any k)."""
    if k < 1:
        raise ValueError(f"{name} kernel takes k >= 1; got k = {k}")
    if k > kmax:
        raise NotImplementedError(
            f"{name} kernel takes k <= {kmax} on CUDA (got k = {k}); wider "
            f"factor models are {GENERIC_K}")


def route(name: str, k: int) -> str:
    """The kernel that one of the ``WIDE`` or ``GEN`` entry points launches
    at k: ``name`` itself for k <= KMAX, its wide kernel for KMAX < k <=
    WIDE_KMAX (``name`` itself where one kernel takes every k <= WIDE_KMAX:
    K14), its generic kernel for WIDE_KMAX < k <= GEN_KMAX where it has one
    (``GEN``); raises as ``check_k`` past its range."""
    check_k(name, k, GEN_KMAX if name in GEN else WIDE_KMAX)
    if k <= KMAX:
        return name
    return WIDE.get(name, name) if k <= WIDE_KMAX else GEN[name]


_SM_COUNT: dict = {}


def gen_ctas(device: torch.device, n: int) -> int:
    """CTAs of a persistent generic grid over n items on ``device``: one an
    SM, at most n."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return max(1, min(n, _SM_COUNT[device]))


def check_lowrank(name: str, k: int, r: int) -> None:
    """Raise unless (k, r) is one the rank-r kernels take: k past GEN_KMAX
    is not ported yet (``NotImplementedError`` naming the ROADMAP row,
    whatever r), and 1 <= r <= k is required."""
    check_k(name, k, GEN_KMAX)
    if not 1 <= r <= k:
        raise ValueError(f"{name} kernel takes 1 <= r <= k; got k = {k}, "
                         f"r = {r}")


def route_lowrank(name: str, k: int, r: int) -> str:
    """The kernel the rank-r entry point ``name`` (``lowrank_basis``,
    ``lowrank_scan``, ``lowrank_smoother``) launches at (k, r): its own
    kernel for k <= LOWRANK_KMAX and r <= LOWRANK_RMAX, else its generic
    kernel ``<name>_gen``; raises as ``check_lowrank`` outside the
    range."""
    check_lowrank(name, k, r)
    if k <= LOWRANK_KMAX and r <= LOWRANK_RMAX:
        return name
    return f"{name}_gen"


def check_dense(name: str, N: int, k: int) -> None:
    """Raise unless (N, k) is one K15's kernels take: N, k >= 1 is
    required, N or k past GEN_KMAX not ported yet (the plain twin takes any
    N and k)."""
    if N < 1 or k < 1:
        raise ValueError(f"{name} kernel takes N, k >= 1; got N = {N}, "
                         f"k = {k}")
    if N > GEN_KMAX or k > GEN_KMAX:
        raise NotImplementedError(
            f"{name} kernel takes N <= {GEN_KMAX} and k <= {GEN_KMAX} on "
            f"CUDA (got N = {N}, k = {k}); past that is {GENERIC_K}")


def route_dense(name: str, N: int, k: int) -> str:
    """The kernel K15's entry point launches at (N, k): its own kernel
    (one warp's N x N Cholesky, shared memory) for N, k <= WIDE_KMAX, else
    ``<name>_gen``; raises as ``check_dense`` outside the range."""
    check_dense(name, N, k)
    return name if N <= WIDE_KMAX and k <= WIDE_KMAX else f"{name}_gen"


def route_sv(name: str, k: int, M: int) -> str:
    """The kernel K10's entry point ``name`` (``sv_rbpf``, ``sv_ffbs``)
    launches for k factors and M particles: its own kernel for k <= KMAX
    and M <= SV_MMAX, else its generic kernel (``GEN``), which takes any M;
    M < 1 is an error, k past GEN_KMAX raises as ``route``."""
    if M < 1:
        raise ValueError(f"{name} kernel takes M >= 1 particles; got {M}")
    got = route(name, k)
    return GEN[name] if M > SV_MMAX else got


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
    fn = getattr(_lib(source, suffix), f"{name}_{suffix}")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    rc = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name}_{suffix} failed to launch: "
                           f"cudaError {rc}")


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Launch kernel ``name`` in ``dtype`` on the current CUDA stream and
    count its device kernels in ``LAUNCHES`` (``DEVICE_LAUNCHES``, else
    one).

    ``args`` are the C arguments before the stream: tensors (passed by
    their data pointer; the caller keeps them alive), ``None`` for a null
    pointer, and Python ints and floats.
    """
    _call(KERNELS, name, dtype, args)
    LAUNCHES[name] += DEVICE_LAUNCHES.get(name, 1)


def query(name: str, dtype: torch.dtype, *args) -> int:
    """The int that sizing rule ``name`` (``QUERIES``) in ``dtype``
    returns for ``args``; nothing is launched or counted."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: no rule for dtype {dtype}")
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(_lib(QUERIES[name][0], suffix), f"{name}_{suffix}")(*args)


def probe(name: str, dtype: torch.dtype, *args) -> None:
    """Launch measurement kernel ``name`` (``PROBES``) as ``launch`` does,
    without counting it."""
    _call(PROBES, name, dtype, args)
