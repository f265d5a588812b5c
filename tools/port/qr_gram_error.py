#!/usr/bin/env python3
"""How far the square-root engine (pit_qr) past k = 10 stands from the
exact loglik, on the CPU, with the port's plain twins (which match the
JAX package's generic branches to ~1e-14 in f64, tests/test_torch_qr_gen.py).

    python3 tools/port/qr_gram_error.py [--reference]

Past QR_UNROLL_K_MAX = 10 the reference forms tria from the Gram matrix
with the dtype's jitter (1e-6 in f32, 1e-10 in f64), which lands on
posterior factors whose Gram is O(1/N).  Prints one JSON line each:

- ``loglik``: ``pit_qr_filter``'s loglik against the f64 ``info_filter``'s
  at the true params of the masked headline panels of ``chip_smoke``'s
  qgen group (``qgen_panel``; at N = 2,000 the k = 25 one's seed),
  |ll - ll_info64| / |ll_info64|, f32 and f64, at (k, N) = (25, 2,000),
  (25, 10,000), (50, 10,000);
- ``fit``: a 10-iteration f32 ``fit(filter="pit_qr")`` at k = 25 on the
  masked headline panel (the stop rule's iterations and logliks) beside
  the f32 ``info`` fit;
- ``mf``: the S3 route ``MixedFreqSpec(1600, 400, 5, time_scan="pit_qr")``
  from its PCA init: in f64 the 2-update loglik against
  ``mf_loglik_eval(precise=True)``; in f32 the first E-step's loglik.

``--reference`` adds the JAX package's f32 fit and f32 S3 fit on the same
panels and ``init``: the JAX package's f64 ``pit_qr_filter`` beside the
port's f64 twins at the PCA init of the standardized masked headline
panels at k = 25 and 50 (N = 10,000; ``chip_smoke``'s qgen contract
points), each against the f64 ``info_filter``'s loglik there (imports
``dfm_tpu``; set JAX_PLATFORMS=cpu).  Uses four CPU threads; ~2 minutes,
~5 with ``--reference``.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import dfm_tpu_torch as dt  # noqa: E402
from dfm_tpu_torch.models import mixed_freq as mf  # noqa: E402
from dfm_tpu_torch.ssm import info_filter as inf  # noqa: E402
from dfm_tpu_torch.ssm import parallel_filter as pf  # noqa: E402
from dfm_tpu_torch.ssm.params import SSMParams  # noqa: E402

CPU64 = dict(device="cpu", dtype=torch.float64)


def loglik_errors() -> None:
    for k, N_ in ((25, 2000), (25, 10_000), (50, 10_000)):
        _, W, Yfull, p = (cs.qgen_panel(0, k) if N_ == cs.N else
                          cs.panel(cs.WIDE_SEED, N_=N_, K_=k))
        Yz = torch.tensor(np.where(W > 0, Yfull, 0.0))
        Wt = torch.tensor(W)
        ref = float(inf.info_filter(Yz, SSMParams.from_numpy(p), Wt).loglik)
        err = {}
        for dtype in (torch.float32, torch.float64):
            pt = SSMParams.from_numpy(p, dtype=dtype, device="cpu")
            ll = float(pf.pit_qr_filter(Yz.to(dtype), pt, Wt.to(dtype))
                       .loglik)
            err[str(dtype)[6:]] = abs(ll - ref) / abs(ref)
        print(json.dumps({"loglik": "pit_qr vs f64 info", "k": k, "N": N_,
                          "T": cs.T, "rel_err": err}), flush=True)


def init_errors() -> None:
    import jax.numpy as jnp
    from dfm_tpu.ssm import parallel_filter as jpf
    from dfm_tpu.ssm.params import SSMParams as JP
    for k in cs.QGEN_FIT_KS:
        Ynan, W, _, _ = cs.qgen_panel(0, k)
        Z, _ = cs.data.standardize(Ynan, mask=W)
        Z = np.where(W > 0, np.nan_to_num(Z), 0.0)
        Zt, Wt = torch.tensor(Z), torch.tensor(W)
        p = cs.pca_init_device(Zt, k)
        exact = inf.loglik_eval(Zt, p, mask=W, precise=True)
        port = float(pf.pit_qr_filter(Zt, SSMParams.from_numpy(p), Wt)
                     .loglik)
        ref = float(jpf.pit_qr_filter(jnp.asarray(Z), JP.from_numpy(
            p, jnp.float64), mask=jnp.asarray(W)).loglik)
        print(json.dumps({"init": "pit_qr f64 at the PCA init", "k": k,
                          "N": cs.N, "T": cs.T, "loglik_exact_f64": exact,
                          "rel_err": {"jax": abs(ref - exact) / abs(exact),
                                      "port": abs(port - exact) / abs(exact)},
                          "port_vs_jax": abs(port - ref) / abs(exact)}),
              flush=True)


def fits(reference: bool) -> None:
    k = 25
    Ynan = cs.qgen_panel(0, k)[0]
    out = {}
    for flt in ("pit_qr", "info"):
        r = dt.fit(dt.DynamicFactorModel(k), Ynan, max_iters=10, tol=0.0,
                   backend=dt.TorchBackend(device="cpu",
                                           dtype=torch.float32, filter=flt))
        out[flt] = {"n_iters": r.n_iters, "logliks": list(r.logliks)}
    if reference:
        from dfm_tpu.api import DynamicFactorModel, TPUBackend, fit
        r = fit(DynamicFactorModel(k), Ynan, max_iters=10, tol=0.0,
                backend=TPUBackend(dtype=np.float32, filter="pit_qr"))
        out["jax pit_qr"] = {"n_iters": r.n_iters,
                             "logliks": [float(x) for x in r.logliks]}
    print(json.dumps({"fit": "f32 masked headline", "k": k, **out}),
          flush=True)


def mixed_freq(reference: bool) -> None:
    Y, W = cs.mf_panel(1001)
    spec = cs.mf_spec("pit_qr")
    Yz, Wm, init = cs.mf_inputs((Y, W), spec)
    Yt, Wt = torch.tensor(Yz), torch.tensor(Wm)
    p0 = mf.MFParams(*init).to(**CPU64)
    p2 = mf.mf_em_scan(Yt, Wt, p0, spec, 2)[0]
    own = float(mf.mf_em_core(Yt, Wt, p2, spec)[1])
    exact = mf.mf_loglik_eval(Yz, Wm, p2, spec, device="cpu")
    ll32 = float(mf.mf_em_core(Yt.float(), Wt.float(),
                               mf.MFParams(*init).to("cpu", torch.float32),
                               spec)[1])
    rec = {"mf": "S3 pit_qr", "m": spec.state_dim,
           "f64_rel_err_2_updates": abs(own - exact) / abs(exact),
           "f32_first_loglik": ll32}
    if reference:
        from dfm_tpu.models import mixed_freq as jm
        sj = jm.MixedFreqSpec(n_monthly=cs.MF_NM, n_quarterly=cs.MF_NQ,
                              n_factors=cs.MF_K, time_scan="pit_qr")
        r = jm.mf_fit(Y, sj, mask=W, max_iters=2, tol=0.0, dtype=np.float32)
        rec["jax_f32_logliks"] = [float(x) for x in r.logliks]
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.reference:
        import jax
        jax.config.update("jax_enable_x64", True)
    loglik_errors()
    if args.reference:
        init_errors()
    fits(args.reference)
    mixed_freq(args.reference)
    return 0


if __name__ == "__main__":
    sys.exit(main())
