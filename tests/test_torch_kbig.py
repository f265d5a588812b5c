"""The lone info and lowrank paths past k = 32, where the card takes the
generic kernels (K2-gen, the K4-gen pair, K1-gen, K3-gen), against dfm_tpu
at float64 on the CPU.

The CPU runs each kernel's plain twin, which takes any k, so these tests
hold the paths' algebra at k = 33 and 40 against the JAX package: single
passes at 1e-10 relative, the EM paths (fits, the fused fit, a session) at
1e-9 (each iteration carries ~1e-13 rounding into the next params), the
mixed-frequency ``seq`` fit at k = 7 (augmented width m = 35) at 1e-9.  The
masked panel (70 series, 60 steps) has scattered missing values, a fully
missing step, a step observing fewer than k series and a never-observed
series (observed once for the fits: ``fit`` refuses an all-missing
column); the lowrank fits (rank 4) run on it without the fully missing
step, where Gam_t would be singular but for its jitter (the two packages
then part at rounding).  ``kernels.route``: the wide kernel at k = 32 (K14's
own kernel), the generic one for 33..128 (the batched twins', K5a's, K5b's
and K14's too), ``NotImplementedError`` naming the ROADMAP row at 129.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu import open_session as jopen
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.backends import cpu_ref as jcpu
from dfm_tpu.estim import em as jem
from dfm_tpu.models import mixed_freq as jm
from dfm_tpu.ssm import info_filter as jif
from dfm_tpu.ssm import kalman as jk
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.backends import cpu_ref as tcpu
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.models import mixed_freq as tm
from dfm_tpu_torch.ssm import info_filter as tif
from dfm_tpu_torch.ssm import kalman as tk
from dfm_tpu_torch.ssm.params import FilterResult
from dfm_tpu_torch.ssm.params import SSMParams as TP
from dfm_tpu_torch.utils.data import Standardizer
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
KS = (33, 40)
T, N = 60, 70
FULL_MISS, FEW, NEVER = 9, 23, 5
ITERS = 3
CPU64 = dict(device="cpu", dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _panel(k):
    """(true params, fully observed Y, mask, Y with NaN at missing) at k."""
    rng = np.random.default_rng(1300 + k)
    p = dgp.dfm_params(N, k, rng)
    Y, _ = dgp.simulate(p, T, rng)
    Y = 1.5 * Y + 0.5
    W = (rng.random(Y.shape) >= 0.1).astype(np.float64)
    W[FULL_MISS] = 0.0
    W[FEW] = 0.0
    W[FEW, :k - 3] = 1.0                 # fewer than k series observed
    W[:, NEVER] = 0.0
    return p, Y, W, np.where(W > 0, Y, np.nan)


def _fit_panel(k, lowrank=False):
    """The masked panel as ``fit`` takes it: the never-observed series
    observed once, at step 0 (``fit`` refuses an all-missing column); for
    the lowrank fits also with its fully missing step observed."""
    _, Y, W, _ = _panel(k)
    W = W.copy()
    W[0, NEVER] = 1.0
    if lowrank:
        W[FULL_MISS] = 1.0
    return np.where(W > 0, Y, np.nan)


def _inputs(k, masked):
    p, Y, W, Ynan = _panel(k)
    if masked:
        return (p, jnp.asarray(Ynan), jnp.asarray(W), torch.as_tensor(Ynan),
                torch.as_tensor(W))
    return p, jnp.asarray(Y), None, torch.as_tensor(Y), None


# ------------------------------------------------------------- passes ---

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_passes_match_jax(k, masked):
    """obs_stats, info_scan, quad_local, loglik_terms_local and
    rts_smoother: the twins of K2-gen, K4-gen (both passes) and K1-gen."""
    p, Yj, Wj, Yt, Wt = _inputs(k, masked)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    sj = jif.obs_stats(Yj, pj.Lam, pj.R, mask=Wj)
    st = tif.obs_stats(Yt, pt.Lam, pt.R, mask=Wt)
    for got, want in zip(st, sj):
        assert tuple(got.shape) == tuple(want.shape)
        close(got, want, PASS_RTOL)
    outs_j = jif.info_scan(sj, pj.A, pj.Q, pj.mu0, pj.P0)
    outs_t = tif.info_scan(st, pt.A, pt.Q, pt.mu0, pt.P0)
    for got, want in zip(outs_t, outs_j):
        close(got, want, PASS_RTOL)
    qj, _ = jif.quad_local(Yj, pj.Lam, pj.R, outs_j[0], Wj)
    close(tif.quad_local(Yt, pt.Lam, pt.R, outs_t[0], Wt), qj, PASS_RTOL)
    qj, Uj = jif.loglik_terms_local(Yj, pj.Lam, pj.R, outs_j[0], Wj)
    qt, Ut = tif.loglik_terms_local(Yt, pt.Lam, pt.R, outs_t[0], Wt)
    assert qt.dtype == torch.float64 and tuple(Ut.shape) == (T, k)
    close(qt, qj, PASS_RTOL)
    close(Ut, Uj, PASS_RTOL)
    kj = jif.info_filter(Yj, pj, mask=Wj)
    kt = tif.info_filter(Yt, pt, mask=Wt)
    close(float(kt.loglik), float(kj.loglik), PASS_RTOL)
    smj, smt = jk.rts_smoother(kj, pj), tk.rts_smoother(kt, pt)
    for got, want in zip(smt, smj):
        close(got, want, PASS_RTOL)
    if masked:
        assert float(st.n[FULL_MISS]) == 0.0
        assert 0 < float(st.n[FEW]) < k


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("ridge", [None, 0.3])
def test_masked_mstep_rows_match_jax(k, ridge):
    """K3-gen's twin on the masked panel: a never-observed series (S_ff =
    I, zero loadings) and a loading ridge."""
    p, Yj, Wj, Yt, Wt = _inputs(k, True)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    smj = jk.rts_smoother(jif.info_filter(Yj, pj, mask=Wj), pj)
    smt = tk.rts_smoother(tif.info_filter(Yt, pt, mask=Wt), pt)
    EffT_j, _ = jem.moments(smj)
    EffT_t, _ = tem.moments(smt)
    Lj, Rj = jem.mstep_rows(Yj, Wj, smj.x_sm, EffT_j, smj.P_sm,
                            EffT_j.sum(0), 1e-6, lam_ridge=ridge)
    Lt, Rt = tem.mstep_rows(Yt, Wt, smt.x_sm, EffT_t, smt.P_sm,
                            EffT_t.sum(0), 1e-6, lam_ridge=ridge)
    close(Lt, Lj, PASS_RTOL)
    close(Rt, Rj, PASS_RTOL)
    assert float(Lt[NEVER].abs().max()) == 0.0


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_em_step_matches_jax(k, masked):
    p, Yj, Wj, Yt, Wt = _inputs(k, masked)
    Yj = jnp.nan_to_num(Yj) if masked else Yj
    Yt = torch.nan_to_num(Yt) if masked else Yt
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    got, llt, _ = tem.em_step(Yt, pt, Wt, tem.EMConfig(filter="info"))
    want, llj, _ = jem.em_step(Yj, pj, Wj, jem.EMConfig(filter="info"))
    close(float(llt), float(llj), FIT_RTOL)
    for g, w in zip(got, want):
        close(g, w, FIT_RTOL)


# --------------------------------------------------------------- fits ---

FITS = [(k, flt, masked) for k in KS
        for flt, masked in (("info", True), ("info", False),
                            ("lowrank", True))]


@pytest.mark.parametrize("k,flt,masked", FITS,
                         ids=[f"k{k}-{f}-{'masked' if m else 'unmasked'}"
                              for k, f, m in FITS])
def test_fit_matches_jax(k, flt, masked):
    Y = _fit_panel(k, flt == "lowrank") if masked else _panel(k)[1]
    extra = {"rank": 4} if flt == "lowrank" else {}
    kw = dict(max_iters=ITERS, tol=0.0)
    rj = jfit(JModel(k), Y, backend=TPUBackend(dtype=np.float64, filter=flt,
                                               **extra), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(k), Y,
                 backend=dtt.TorchBackend(filter=flt, **extra, **CPU64), **kw)
    assert rt.filter == rj.filter == flt
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=FIT_RTOL)
    for name in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, name), getattr(rj.params, name), FIT_RTOL)
    close(rt.factors, rj.factors, FIT_RTOL)
    close(rt.factor_cov, rj.factor_cov, FIT_RTOL)


def test_masked_auto_resolves_to_info_past_32():
    """``filter="auto"`` on a masked panel at k = 40 is the info engine,
    the same fit as ``filter="info"``."""
    k = 40
    Ynan = _fit_panel(k)
    kw = dict(max_iters=1, tol=0.0)
    ra = dtt.fit(dtt.DynamicFactorModel(k), Ynan,
                 backend=dtt.TorchBackend(filter="auto", **CPU64), **kw)
    ri = dtt.fit(dtt.DynamicFactorModel(k), Ynan,
                 backend=dtt.TorchBackend(filter="info", **CPU64), **kw)
    assert ra.filter == "info"
    np.testing.assert_array_equal(ra.logliks, ri.logliks)


@pytest.mark.parametrize("k", KS)
def test_fused_fit_and_session_match_jax(k):
    """``fit(fused=True)`` on the masked panel's first 50 rows, then an
    info session on the JAX fit's params with two queries of 3 rows."""
    Ynan = _fit_panel(k)
    jb = TPUBackend(dtype=np.float64, filter="info", fused_chunk=2)
    tb = dtt.TorchBackend(filter="info", fused_chunk=2, **CPU64)
    kw = dict(fused=True, max_iters=ITERS, tol=0.0)
    rj = jfit(JModel(k), Ynan[:50], backend=jb, robust=False, **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(k), Ynan[:50], backend=tb, **kw)
    assert rt.filter == rj.filter == "info"
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=FIT_RTOL)
    for name in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, name), getattr(rj.params, name), FIT_RTOL)
    close(rt.factors, rj.factors, FIT_RTOL)
    s = rj.standardizer
    rt = dtt.FitResult(
        params=rj.params, logliks=rj.logliks, factors=rj.factors,
        factor_cov=rj.factor_cov, converged=rj.converged,
        n_iters=rj.n_iters, standardizer=Standardizer(s.mean, s.scale),
        model=dtt.DynamicFactorModel(k), backend="torch", history=[],
        filter=rj.filter)
    skw = dict(capacity=T, max_update_rows=4, max_iters=2, tol=0.0)
    js = jopen(rj, Ynan[:50], backend=jb, robust=False, **skw)
    ts = dtt.open_session(rt, Ynan[:50], backend=tb, **skw)
    for a, b in ((50, 53), (53, 56)):
        tu, ju = ts.update(Ynan[a:b]), js.update(Ynan[a:b])
        assert (tu.t, tu.n_iters) == (ju.t, ju.n_iters)
        for name in ("nowcast", "nowcast_sd", "factors", "factor_cov",
                     "logliks"):
            close(getattr(tu, name), getattr(ju, name), FIT_RTOL)
        for key in ("y", "f"):
            close(tu.forecasts[key], ju.forecasts[key], FIT_RTOL)


def test_mf_seq_fit_at_m35_matches_jax():
    """The mixed-frequency ``seq`` fit at k = 7: augmented width m = 35,
    past 32, so on the card K2, K1 and the f64 K4 pair run their generic
    kernels."""
    nm, nq, k = 50, 12, 7
    rng = np.random.default_rng(1335)
    Y, mask, _, _ = dgp.simulate_mixed_freq(nm, nq, T, k, rng)
    W = mask * dgp.random_mask(T, nm + nq, rng, 0.1)
    W[T - 4:, :nm // 3] = 0.0
    W[17] = 0.0
    W[:, 2] = 0.0
    Y = np.where(W > 0, Y, np.nan)
    kw = dict(n_monthly=nm, n_quarterly=nq, n_factors=k, time_scan="seq")
    sj, st = jm.MixedFreqSpec(**kw), tm.MixedFreqSpec(**kw)
    assert st.state_dim == 35
    rj = jm.mf_fit(Y, sj, mask=W, max_iters=ITERS, tol=0.0, fused_chunk=2)
    rt = tm.mf_fit(Y, st, mask=W, max_iters=ITERS, tol=0.0, fused_chunk=2,
                   device="cpu")
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=FIT_RTOL)
    for name in tm.MFParams._fields:
        close(np.asarray(getattr(rt.params, name)),
              np.asarray(getattr(rj.params, name)), FIT_RTOL)


# ------------------------------------------------------------ routing ---

def _meta(*shape):
    """A tensor with no storage: a wrapper takes its kernel route for any
    device but the CPU, so a "meta" tensor reaches the range check without
    a card."""
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("k,tier", [(32, "wide"), (33, "gen"), (100, "gen"),
                                    (128, "gen")])
def test_gen_routes(k, tier):
    for name in kernels.GEN:
        got = kernels.route(name, k)
        # K14 (pit_elements, pit_scan) has one kernel at every k <= 32.
        assert got == (kernels.WIDE.get(name, name) if tier == "wide"
                       else kernels.GEN[name])
        # Each routed kernel is in its entry point's source, but the
        # generic kernels of K10, K11 and the K4 pair (and K4b's), which
        # have sources of their own.
        src = {"sv_rbpf_gen": "sv_gen.cu", "sv_ffbs_gen": "sv_gen.cu",
               "loading_filter_gen": "tv_loadings_gen.cu",
               "loading_smoother_gen": "tv_loadings_gen.cu",
               "info_scan_gen": "info_scan_gen.cu",
               "rts_smoother_gen": "info_scan_gen.cu",
               "batched_info_scan_gen": "info_scan_gen.cu",
               "batched_rts_gen": "info_scan_gen.cu"}.get(
                   got, kernels.KERNELS[name][0])
        assert kernels.KERNELS[got][0] == src


def test_past_128_and_unported_names_raise_before_any_launch():
    for name in kernels.GEN:
        with pytest.raises(NotImplementedError, match="Generic k") as err:
            kernels.route(name, 129)
        assert kernels.GENERIC_K in str(err.value)
    for name in ("ss_cov_path", "affine_scan"):
        assert kernels.route(name, 33) == kernels.GEN[name]
        with pytest.raises(NotImplementedError, match="Generic k"):
            kernels.route(name, 129)
    for name in ("batched_info_scan", "batched_rts", "batched_quad",
                 "batched_quad_masked", "batched_solve_rows",
                 "batched_obs_stats", "batched_mstep_rows"):
        with pytest.raises(NotImplementedError, match="Generic k"):
            kernels.route(name, 129)
    kernels.reset_launches()
    k = 129
    st = tif.ObsStats(_meta(4, k), _meta(4, k, k), _meta(4), _meta(4))
    calls = [
        lambda: tif.obs_stats(_meta(4, 8), _meta(8, k), _meta(8),
                              _meta(4, 8)),
        lambda: tif.info_scan(st, _meta(k, k), _meta(k, k), _meta(k),
                              _meta(k, k)),
        lambda: tif.quad_local(_meta(4, 8), _meta(8, k), _meta(8),
                               _meta(4, k)),
        lambda: tif.loglik_terms_local(_meta(4, 8), _meta(8, k), _meta(8),
                                       _meta(4, k)),
        lambda: tem.mstep_rows(_meta(4, 8), _meta(4, 8), _meta(4, k),
                               _meta(4, k, k), _meta(4, k, k), None, 1e-6),
        lambda: tk.rts_smoother(
            FilterResult(_meta(4, k), _meta(4, k, k), _meta(4, k),
                         _meta(4, k, k), _meta()),
            TP(_meta(8, k), _meta(k, k), _meta(k, k), _meta(8), _meta(k),
               _meta(k, k))),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="Generic k"):
            call()
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("k,rho", [(32, 0.7), (33, 0.7), (48, 0.95),
                                   (64, 0.998)])
def test_stationary_p0_matches_the_kronecker_solve(k, rho):
    """The PCA init's stationary P0 (``var_tail``, ``dgp.dfm_params``): to
    k = 32 the reference's Kronecker solve bit for bit, past 32 Smith's
    doubling iteration within 1e-12 of it, up to a spectral radius of
    0.998."""
    rng = np.random.default_rng(1450 + k)
    A = dgp.stable_var1(k, rng, rho)
    X = rng.standard_normal((k, k))
    Q = X @ X.T / k + 1e-3 * np.eye(k)
    got = tcpu._solve_discrete_lyapunov_or_eye(A, Q)
    want = jcpu._solve_discrete_lyapunov_or_eye(A, Q)
    if k <= 32:
        np.testing.assert_array_equal(got, want)
    else:
        close(got, want, 1e-12)
    close(A @ got @ A.T + Q, got, 1e-13)
