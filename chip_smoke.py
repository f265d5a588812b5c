#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (dfm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (and the script exits non-zero) on failure:

1. setup: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel from ``dfm_tpu_torch/csrc`` (one nvcc per source, in
   parallel), with its seconds.
2. kernels: every kernel of the fit path at the headline shape (T = 500,
   N = 10,000, k = 10), in f32 and f64, against its plain-torch version on
   the same inputs on the card, within a stated relative tolerance; timed
   with CUDA events beside the plain version, a one-call library yardstick
   where one exists, and the least time the card could take (bytes over
   memory rate or operations over peak rate, whichever is larger); each
   kernel also with a cold L2 (flushed before every call), and K4 beside
   its measured latency floor (``csrc/step_chain.cu``: one step's
   dependent chain, T steps).  Then the same comparisons, untimed, at
   k = 1, 3 and 16 on a small panel, K3 there with a loading ridge.
3. fit: ``dfm_tpu_torch.fit`` on a simulated 10,000 x 500, k = 10, AR(1)
   panel with a ragged edge and scattered missing values (filter="auto"
   must resolve to "info"), then the same panel fully observed with
   filter="info": 20 EM iterations with tol = 0, the reporting smooth and
   a 12-step forecast.  Logliks must be finite and non-decreasing within
   the f32 noise floor, factors and forecasts finite, and every kernel of
   the path launched (launch counts are reset just before each fit).
4. reference: the same fit at 120 x 80, k = 3, masked and not, on the card
   in f64 against the CPU in f64 (the plain versions), within 1e-9.
5. contract: from one init, 3 EM iterations in f32 and in f64; the f32
   params re-evaluated in f64 must be within 1e-5 relative of the f64
   trajectory's loglik at iteration 3, masked and unmasked.

Output: one JSON line per kernel and dtype, one per fit and contract
check, then the {"kernels": [...]} summary, the card line and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import dfm_tpu_torch as dt
from dfm_tpu_torch import kernels
from dfm_tpu_torch.estim.em import (EMConfig, em_fit_scan, moments,
                                    mstep_rows, mstep_rows_plain,
                                    noise_floor_for)
from dfm_tpu_torch.estim.init import pca_init_device
from dfm_tpu_torch.ops.precision import highest_precision
from dfm_tpu_torch.ssm import info_filter as inf
from dfm_tpu_torch.ssm.kalman import rts_smoother, rts_smoother_plain
from dfm_tpu_torch.ssm.params import FilterResult, SSMParams
from dfm_tpu_torch.utils import data, dgp

T, N, K = 500, 10_000, 10
# H100 SXM, NVIDIA data sheet: HBM rate; FP32 outside the tensor cores
# (TF32 on them is a lower precision than f32), FP64 on the tensor cores
# (the same IEEE f64 type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
L2_FLUSH_BYTES = 256 * 2**20                   # > 5x the H100's 50 MB L2
# Relative tolerance of each kernel against its plain version, as
# max|kernel - plain| / max|plain| over each output.  f64: 1e-10 for the
# one-pass reductions, 1e-9 where a solve or a 500-step recursion
# compounds rounding.  f32: the reductions sum 10,000 terms in another
# order (~sqrt(N) eps relative), the solves and recursions amplify by the
# condition of the k x k systems.
TOL = {torch.float32: {"quad_local": 1e-5, "obs_stats": 1e-5,
                       "mstep_rows": 1e-4, "info_scan": 1e-4,
                       "rts_smoother": 1e-4},
       torch.float64: {"quad_local": 1e-10, "obs_stats": 1e-10,
                       "mstep_rows": 1e-9, "info_scan": 1e-9,
                       "rts_smoother": 1e-9}}
# The TPU routine each kernel replaces.
REPLACES = {"quad_local": "dfm_tpu/ssm/info_filter.py:159",
            "obs_stats": "dfm_tpu/ssm/info_filter.py:69",
            "mstep_rows": "dfm_tpu/estim/em.py:163",
            "info_scan": "dfm_tpu/ssm/info_filter.py:104",
            "rts_smoother": "dfm_tpu/ssm/kalman.py:84"}
# Constants of the latency probe's chain: fma x h + c, pivot b - (a/d)^2,
# division by e (csrc/step_chain.cu).
CHAIN_CONSTS = [0.5, 1.0, 1.0, 3.0, 2.0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Mean milliseconds of one call, from CUDA events around a run of
    back-to-back calls after a warm-up (~0.3 s of work, 3..50 calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    reps = max(3, min(50, int(0.3 / max(one, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 10) -> float:
    """Mean milliseconds of one call with a cold L2: a buffer five times
    the L2 is overwritten before each call, and CUDA events time the call
    alone."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def latency_ms(name: str, dtype, k: int = K, T_: int = T) -> float:
    """Measured latency floor of a K4 pass at (T_, k): the probe runs one
    step's dependent chain T_ times in one thread (csrc/step_chain.cu)."""
    consts = torch.tensor(CHAIN_CONSTS, dtype=dtype, device="cuda")
    out = torch.empty(1, dtype=dtype, device="cuda")
    backward = int(name == "rts_smoother")
    ms = cuda_ms(lambda: kernels.probe("step_chain", dtype, consts, out, T_,
                                       k, backward))
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"latency probe for {name}: non-finite chain")
    return ms


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def work(name: str, s: int, masked: bool = True) -> tuple:
    """(bytes, flops) the function needs at the headline shape: each input
    read once and each output written once; multiply-adds count as 2."""
    k, TN, k2 = K, T * N, K * K
    m = TN if masked else 0
    if name == "quad_local":
        return (s * (TN + m + N * k + N + T * k) + 8 * T,
                TN * (2 * k + 5))
    if name == "obs_stats":
        return (s * (2 * TN + N * k + N + T * (k + k2 + 2)),
                TN * (2 * k + k * (k + 1) + 6))
    if name == "mstep_rows":
        return (s * (2 * TN + T * (k + 2 * k2) + N * (k + 1)),
                TN * (4 * k + 2 * k * (k + 1) + 5) + N * (k ** 3 // 3 + 6 * k2))
    if name == "info_scan":
        return (s * (T * k + (T * k2 if masked else k2) + 3 * k2 + k
                     + T * (2 * k + 2 * k2 + 1)),
                T * (12.67 * k ** 3 + 4 * k2))
    if name == "rts_smoother":
        return (s * (T * (2 * k + 2 * k2) + k2 + T * (k + 2 * k2)),
                T * (10.33 * k ** 3 + 4 * k2))
    raise KeyError(name)


def panel(seed: int, T_: int = T, N_: int = N, K_: int = K):
    """Simulated panel (the headline shape by default): (Y with NaN at
    missing, mask, the fully observed Y, true params)."""
    rng = np.random.default_rng(seed)
    p = dgp.dfm_params(N_, K_, rng)
    Y, _ = dgp.simulate(p, T_, rng)
    W = np.ones((T_, N_))
    ragged = rng.random(N_) < 0.30            # ragged edge: last 12 rows
    W[T_ - 12:, ragged] = 0.0
    W[rng.random((T_, N_)) < 0.05] = 0.0      # 5% scattered
    return np.where(W > 0, Y, np.nan), W, Y, p


def kernel_cases(Ynan, W, Yfull, p, dtype, lam_ridge=None):
    """(name, masked, kernel call, plain call, library call or None) for
    every kernel of the fit path, on inputs the plain pipeline makes from
    this panel on the card; K3 with ``lam_ridge`` when given.  Call under
    ``highest_precision()``."""
    dev = torch.device("cuda")
    Yt = torch.as_tensor(Ynan, dtype=dtype, device=dev).contiguous()
    Yf = torch.as_tensor(Yfull, dtype=dtype, device=dev).contiguous()
    mt = torch.as_tensor(W, dtype=dtype, device=dev).contiguous()
    pt = SSMParams.from_numpy(p, dtype=dtype, device=dev)
    stats = inf.obs_stats_plain(Yt, pt.Lam, pt.R, mt)
    scan = inf.info_scan_plain(stats, pt.A, pt.Q, pt.mu0, pt.P0)
    kf = FilterResult(*scan[:4], torch.zeros((), dtype=dtype))
    sm = rts_smoother_plain(kf, pt)
    EffT, _ = moments(sm)
    ustats = inf.obs_stats_plain(Yf, pt.Lam, pt.R)
    uscan = inf.info_scan_plain(ustats, pt.A, pt.Q, pt.mu0, pt.P0)
    return [
        ("obs_stats", True,
         lambda: inf.obs_stats(Yt, pt.Lam, pt.R, mt),
         lambda: inf.obs_stats_plain(Yt, pt.Lam, pt.R, mt),
         lambda: torch.einsum("nk,tn,n,nl->tkl", pt.Lam, mt, 1.0 / pt.R,
                              pt.Lam)),
        ("info_scan", True,
         lambda: inf.info_scan(stats, pt.A, pt.Q, pt.mu0, pt.P0),
         lambda: inf.info_scan_plain(stats, pt.A, pt.Q, pt.mu0, pt.P0),
         None),
        ("quad_local", True,
         lambda: inf.quad_local(Yt, pt.Lam, pt.R, scan[0], mt),
         lambda: inf.quad_local_plain(Yt, pt.Lam, pt.R, scan[0], mt), None),
        ("rts_smoother", True, lambda: rts_smoother(kf, pt),
         lambda: rts_smoother_plain(kf, pt), None),
        ("mstep_rows", True,
         lambda: mstep_rows(Yt, mt, sm.x_sm, EffT, sm.P_sm, None, 1e-6,
                            lam_ridge=lam_ridge),
         lambda: mstep_rows_plain(Yt, mt, sm.x_sm, EffT, sm.P_sm, 1e-6,
                                  lam_ridge),
         None),
        ("info_scan", False,
         lambda: inf.info_scan(ustats, pt.A, pt.Q, pt.mu0, pt.P0),
         lambda: inf.info_scan_plain(ustats, pt.A, pt.Q, pt.mu0, pt.P0),
         None),
        ("quad_local", False,
         lambda: inf.quad_local(Yf, pt.Lam, pt.R, uscan[0]),
         lambda: inf.quad_local_plain(Yf, pt.Lam, pt.R, uscan[0]), None),
    ]


def compare(name: str, masked: bool, dtype, run, plain) -> tuple:
    """(max abs error, max over outputs of max|err| / max|plain|, tol) of
    the kernel against its plain version; raises on a non-finite output or
    past the tolerance."""
    got, ref = run(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    abs_err = rel_err = 0.0
    for g, r in zip(got, ref):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        e = float((g.double() - r.double()).abs().max())
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(float(r.double().abs().max()), 1e-300))
    tol = TOL[dtype][name]
    if not rel_err <= tol:
        raise AssertionError(
            f"{name} ({dtype}, masked={masked}): relative error "
            f"{rel_err:.3e} > tol {tol:.0e}")
    return abs_err, rel_err, tol


def kernel_phase(seed: int) -> dict:
    """Every kernel vs its plain version at the headline shape, f32 and
    f64, timed.  Returns the f32 masked records by kernel name."""
    pan = panel(seed)
    summary = {}
    for dtype in (torch.float32, torch.float64):
        s = torch.finfo(dtype).bits // 8
        floors = {name: latency_ms(name, dtype)
                  for name in ("info_scan", "rts_smoother")}
        with highest_precision():
            for name, masked, run, plain, library in kernel_cases(*pan,
                                                                  dtype):
                n0 = kernels.LAUNCHES[name]
                abs_err, rel_err, tol = compare(name, masked, dtype, run,
                                                plain)
                kernel_ms = cuda_ms(run)
                cold_ms = cuda_ms_cold(run)
                plain_ms = cuda_ms(plain)
                library_ms = cuda_ms(library) if library else None
                nbytes, flops = work(name, s, masked)
                bound_ms, bound_by = bound(nbytes, flops, dtype)
                rec = {"name": name, "masked": masked,
                       "dtype": str(dtype).replace("torch.", ""),
                       "max_rel_err": rel_err, "max_abs_err": abs_err,
                       "tol": tol, "kernel_ms": kernel_ms,
                       "kernel_ms_cold_l2": cold_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "latency_ms": floors.get(name),
                       "launches": kernels.LAUNCHES[name] - n0}
                emit(rec)
                if dtype == torch.float32 and masked:
                    summary[name] = rec
        torch.cuda.empty_cache()
    return summary


def k_sweep(seed: int) -> None:
    """Every kernel at other factor counts (k = 1 and 16, the ends of the
    kernels' compile-time dispatch, and 3) on a 120 x 400 panel, f32 and
    f64, K3 with a loading ridge: error checks only."""
    for k in (1, 3, 16):
        pan = panel(seed + 2, T_=120, N_=400, K_=k)
        for dtype in (torch.float32, torch.float64):
            worst = {}
            with highest_precision():
                for name, masked, run, plain, _ in kernel_cases(
                        *pan, dtype, lam_ridge=0.5):
                    rel = compare(name, masked, dtype, run, plain)[1]
                    worst[name] = max(worst.get(name, 0.0), rel)
            emit({"k_sweep": k, "dtype": str(dtype).replace("torch.", ""),
                  "max_rel_err": worst})


FIT_KERNELS = {True: ("quad_local", "obs_stats", "mstep_rows", "info_scan",
                      "rts_smoother"),
               False: ("quad_local", "info_scan", "rts_smoother")}


def fit_phase(seed: int) -> dict:
    """The two headline fits; returns the masked fit's launch counts."""
    Ynan, _, Yfull, _ = panel(seed + 1)
    model = dt.DynamicFactorModel(n_factors=K, dynamics="ar1")
    counts = {}
    for masked, Y, flt in ((True, Ynan, "auto"), (False, Yfull, "info")):
        backend = dt.TorchBackend(filter=flt)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = dt.fit(model, Y, backend=backend, max_iters=20, tol=0.0)
        y_fore, f_fore = dt.forecast(res, 12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        floor = noise_floor_for(torch.float32, T * N)
        chunk = backend.fused_chunk
        steady = [h["secs"] for h in res.history[chunk:]]
        rec = {"fit": "masked" if masked else "unmasked", "filter": res.filter,
               "n_iters": res.n_iters, "loglik_first": float(lls[0]),
               "loglik_last": float(lls[-1]),
               "max_drop": float(max(0.0, -np.diff(lls).min())),
               "noise_floor": floor, "wall_s": wall,
               "em_iters_per_sec": (len(steady) / sum(steady)
                                    if steady and sum(steady) > 0 else None),
               "launches": launches}
        emit(rec)
        if masked and res.filter != "info":
            raise AssertionError(f"filter='auto' resolved to {res.filter!r}")
        if res.n_iters != 20:
            raise AssertionError(f"fit stopped after {res.n_iters} iterations")
        if not np.isfinite(lls).all():
            raise AssertionError("non-finite loglik")
        if np.diff(lls).min() < -floor:
            raise AssertionError(f"loglik dropped by {-np.diff(lls).min()} "
                                 f"> noise floor {floor}")
        for name, arr in (("factors", res.factors), ("y_fore", y_fore),
                          ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"non-finite {name}")
        if res.factors.shape != (T, K) or y_fore.shape != (12, N):
            raise AssertionError("unexpected output shapes")
        missing = [n for n in FIT_KERNELS[masked] if launches[n] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the fit path: "
                                 f"{missing}")
        if masked:
            counts = launches
    return counts


def reference_phase(seed: int) -> None:
    """The whole fit on a small panel (120 x 80, k = 3), on the card in f64
    against the same fit on the CPU in f64, where every kernel's plain
    version runs: logliks, params, factors and forecasts within 1e-9
    relative (each kernel pass agrees to ~1e-15 in f64; 10 EM iterations
    carry each pass's rounding into the next params)."""
    Ynan, _, Yfull, _ = panel(seed + 3, T_=120, N_=80, K_=3)
    model = dt.DynamicFactorModel(n_factors=3, dynamics="ar1")
    for masked, Y in ((True, Ynan), (False, Yfull)):
        res = {}
        for dev in ("cuda", "cpu"):
            b = dt.TorchBackend(device=dev, dtype=torch.float64, filter="info")
            r = dt.fit(model, Y, backend=b, max_iters=10, tol=0.0)
            res[dev] = (r, dt.forecast(r, 12)[0])
        (rg, yg), (rc, yc) = res["cuda"], res["cpu"]
        errs = {}
        for name, g, c in (("logliks", rg.logliks, rc.logliks),
                           ("Lam", rg.params.Lam, rc.params.Lam),
                           ("R", rg.params.R, rc.params.R),
                           ("A", rg.params.A, rc.params.A),
                           ("factors", rg.factors, rc.factors),
                           ("y_fore", yg, yc)):
            errs[name] = float(np.abs(g - c).max() / np.abs(c).max())
        emit({"reference": "masked" if masked else "unmasked",
              "shape": [120, 80, 3], "max_rel_err": errs, "tol": 1e-9})
        bad = {n: e for n, e in errs.items() if not e <= 1e-9}
        if bad:
            raise AssertionError(f"card fit disagrees with the CPU fit: {bad}")


def contract_phase(seed: int) -> None:
    """BASELINE.json:5 loglik contract at iteration 3 (bench.py's
    definition): f32 params after 2 updates, evaluated in f64, against the
    f64 trajectory's loglik at its 2-update params."""
    Ynan, W, Yfull, _ = panel(seed + 1)
    dev = torch.device("cuda")
    for masked in (True, False):
        Y = Ynan if masked else Yfull
        Wm = W if masked else None
        Z, _ = data.standardize(Y, mask=Wm)
        Z = np.where(np.isfinite(Z), Z, 0.0)
        cfg = EMConfig(filter="info")
        with highest_precision():
            p0 = pca_init_device(
                torch.as_tensor(Z, dtype=torch.float64, device=dev), K)
            lls = {}
            for dtype in (torch.float32, torch.float64):
                Yt = torch.as_tensor(Z, dtype=dtype, device=dev)
                mt = (torch.as_tensor(Wm, dtype=dtype, device=dev)
                      if masked else None)
                pt = SSMParams.from_numpy(p0, dtype=dtype, device=dev)
                ps, ll = em_fit_scan(Yt, pt, 3, mask=mt, cfg=cfg)
                lls[dtype] = (ps, ll.cpu().numpy())
            ref = float(lls[torch.float64][1][2])
            p2 = lls[torch.float32][0][1].to_numpy()
            precise = inf.loglik_eval(
                torch.as_tensor(Z, dtype=torch.float64, device=dev), p2,
                mask=Wm, precise=True)
        rel = abs(precise - ref) / abs(ref)
        fast = abs(float(lls[torch.float32][1][2]) - ref) / abs(ref)
        emit({"contract": "masked" if masked else "unmasked", "iter": 3,
              "loglik_f64": ref, "rel_err_precise": rel,
              "rel_err_fast": fast, "limit": 1e-5})
        if not rel < 1e-5:
            raise AssertionError(f"loglik contract broken: {rel:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    emit({"build_s": kernels.build(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    summary = kernel_phase(args.seed)
    k_sweep(args.seed)
    launches = fit_phase(args.seed)
    reference_phase(args.seed)
    contract_phase(args.seed)
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"dfm_tpu_torch/csrc/{kernels.KERNELS[name][0]}",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": rec["max_abs_err"], "max_rel_err": rec["max_rel_err"],
         "ms": rec["kernel_ms"], "ms_cold_l2": rec["kernel_ms_cold_l2"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "latency_ms": rec["latency_ms"],
         "library_ms": rec["library_ms"]}
        for name, rec in summary.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
