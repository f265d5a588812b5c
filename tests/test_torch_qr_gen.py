"""The square-root engine (pit_qr) past k = 10 and the repaired JAX-shaped
calls, against dfm_tpu at float64 on the CPU.

- Past QR_UNROLL_K_MAX = 10 the JAX package's tria, tri_solve and
  psd_factor, and the element builds' chol and chol_solve, take their
  generic branches (a Gram matrix's jittered Cholesky, solve_triangular,
  an unjittered psd_cholesky, chol_solve).  The port's twins of the
  kernels qr_elements_gen and qr_scan_gen take the same branches: the
  elements, both combines, both scans, the assembly, the smoother
  elements and ``pit_qr_filter`` / ``pit_qr_smoother`` at k = 12 and 25
  to 1e-10 relative, a 3-iteration ``fit(filter="pit_qr")`` at k = 12 and
  ``MixedFreqSpec(time_scan="pit_qr")`` (m = 12 and 10: ``mf_em_core``
  and a 2-iteration fit) to 1e-9.
- In f32 the Gram branch's jitter (1e-6) lands on posterior factors whose
  Gram is O(1/N): the JAX f32 loglik past 10 is far from f64, and the
  port's twin is held to no more than twice the JAX f32 error.
- ``check_qr_k`` routes k <= 10 to the one-thread kernels, 10 < k <= 128
  to the generic ones and raises naming the ROADMAP row at 129, before
  any launch.
- ROADMAP Queue 3, faults 1-3: ``blocked_scan`` takes the JAX signature
  (``block_size`` third), the JAX-shaped calls of fault 2 run against
  their JAX twins, and the keywords of items not ported yet raise
  ``NotImplementedError`` naming the item.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.backends import cpu_ref as jcpu
from dfm_tpu.estim import batched as jbat
from dfm_tpu.estim import em as jem
from dfm_tpu.estim import init as jinit
from dfm_tpu.fleet import buffers as jbuf
from dfm_tpu.models import mixed_freq as jm
from dfm_tpu.models import tv_loadings as jtv
from dfm_tpu.obs import store as jstore
from dfm_tpu.ops import linalg as jla
from dfm_tpu.ops import precision as jprec
from dfm_tpu.ops import scan as jsc
from dfm_tpu.robust import health as jhealth
from dfm_tpu.ssm import info_filter as jif
from dfm_tpu.ssm import parallel_filter as jpf
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.estim import batched as tbat
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.estim import fused as tfused
from dfm_tpu_torch.estim import init as tinit
from dfm_tpu_torch.fleet import buffers as tbuf
from dfm_tpu_torch.models import mixed_freq as tm
from dfm_tpu_torch.models import sv as tsv
from dfm_tpu_torch.models import tv_loadings as ttv
from dfm_tpu_torch.obs import store as tstore
from dfm_tpu_torch.ops import linalg as tla
from dfm_tpu_torch.ops import precision as tprec
from dfm_tpu_torch.ops import scan as tsc
from dfm_tpu_torch.robust import health as thealth
from dfm_tpu_torch.ssm import info_filter as tif
from dfm_tpu_torch.ssm import parallel_filter as tpf
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
KS = (12, 25)
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_all(got, want, rtol, gram=()):
    """Each output to ``rtol``; those at ``gram``, square-root factors,
    through X X' (a factor of a rank-deficient matrix, as psd_factor of
    C_t gives at a step observing fewer than k series, has last columns of
    rounding noise that two Cholesky implementations resolve differently:
    1e-9 apart at k = 25 while X X' agrees to 1e-16)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        if i in gram:
            g, w = (x @ np.swapaxes(x, -1, -2) for x in (g, w))
        close(g, w, rtol)


# The factor outputs of the filter elements (U, Z) and of the smoother
# elements (D).
FILTER_FACTORS, SMOOTHER_FACTORS = (2, 4), (2,)


# ------------------------------------------------ the engine past 10 ---

@functools.lru_cache(maxsize=None)
def _setup(k):
    """(params, Y, mask) at k: 40 x 36, 10% scattered missing, a fully
    missing step and a step observing fewer than k series."""
    rng = np.random.default_rng(300 + k)
    p = dgp.dfm_params(36, k, rng)
    Y, _ = dgp.simulate(p, 40, rng)
    W = dgp.random_mask(*Y.shape, rng, 0.1)
    W[5] = 0.0
    W[9] = 0.0
    W[9, :k - 2] = 1.0
    return p, Y, W


@functools.lru_cache(maxsize=None)
def _stats(k, masked=True):
    p, Y, W = _setup(k)
    Yz = np.where(W > 0, Y, 0.0) if masked else Y
    m = W if masked else None
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    sj = jif.obs_stats(jnp.asarray(Yz), pj.Lam, pj.R,
                       mask=None if m is None else jnp.asarray(m))
    st = tif.obs_stats(_t(Yz), pt.Lam, pt.R,
                       mask=None if m is None else _t(m))
    return pj, pt, sj, st


_jax_prefix = jax.jit(lambda e: jsc.blocked_scan(jpf.qr_combine_filter, e))
_jax_suffix = jax.jit(
    lambda e: jsc.blocked_scan(jpf.qr_combine_smoother, e, reverse=True))
_jax_elements = jax.jit(jpf.qr_filter_elements)
_jax_from_stats = jax.jit(jpf.pit_qr_from_stats)
_jax_smoother_elements = jax.jit(jpf._qr_smoother_elements)
_jax_smoother = jax.jit(jpf.pit_qr_smoother)
_jax_combine = jax.jit(jpf.qr_combine_filter)
_jax_combine_smoother = jax.jit(jpf.qr_combine_smoother)
_jax_filter_smoother = jax.jit(jpf.pit_qr_filter_smoother)
_jax_mf_core = jax.jit(jm.mf_em_core, static_argnums=(3,))


@pytest.mark.parametrize("k", KS)
def test_qr_twins_past_10_match_jax(k):
    """The element build, both combines, both blocked scans, the filter
    assembly, the smoother elements and the smoother assembly: the JAX
    generic branches, 1e-10."""
    pj, pt, sj, st = _stats(k)
    ej = _jax_elements(sj, pj.A, pj.Q, pj.mu0, pj.P0)
    et = tpf.qr_filter_elements(st, pt.A, pt.Q, pt.mu0, pt.P0)
    _close_all(et, ej, PASS_RTOL, FILTER_FACTORS)
    # One combine on a batch of element pairs (steps 1.. with 2..).
    ci = tuple(jnp.asarray(_np(x)[1:-1]) for x in et)
    cj = tuple(jnp.asarray(_np(x)[2:]) for x in et)
    _close_all(tpf.qr_combine_filter(tuple(_t(x) for x in ci),
                                     tuple(_t(x) for x in cj)),
               _jax_combine(ci, cj), PASS_RTOL, FILTER_FACTORS)
    pref_t = tpf.qr_scan(et)
    _close_all(pref_t, _jax_prefix(tuple(jnp.asarray(_np(x)) for x in et)),
               PASS_RTOL, FILTER_FACTORS)
    x_f, U_f = pref_t[1], pref_t[2]
    x_pred, P_pred, P_f, logdetG = tpf.qr_filter_assemble(
        x_f, U_f, st.C, pt.A, pt.Q, pt.mu0, pt.P0)
    want = _jax_from_stats(sj, pj)                 # x_pred, P_pred, x_f, ...
    _close_all((x_pred, P_pred, x_f, P_f, logdetG), want, PASS_RTOL)
    # The smoother elements and the suffix on the filter's moments.
    kt = tpf.FilterResult(x_pred, P_pred, x_f, P_f, None)
    kj = tpf.FilterResult(*(jnp.asarray(_np(x)) for x in kt[:4]), None)
    (elt, Jt) = tpf.qr_smoother_elements(kt, pt.A, pt.Q)
    (elj, Jj) = _jax_smoother_elements(kj, pj.A, pj.Q)
    _close_all(elt + (Jt,), elj + (Jj,), PASS_RTOL, SMOOTHER_FACTORS)
    suf_t = tpf.qr_scan(elt, smoother=True)
    _close_all(suf_t, _jax_suffix(tuple(jnp.asarray(_np(x)) for x in elt)),
               PASS_RTOL, SMOOTHER_FACTORS)
    li = tuple(_t(_np(x)[2:]) for x in elt)
    ee = tuple(_t(_np(x)[1:-1]) for x in elt)
    _close_all(tpf.qr_combine_smoother(li, ee),
               _jax_combine_smoother(tuple(jnp.asarray(_np(x)) for x in li),
                                     tuple(jnp.asarray(_np(x)) for x in ee)),
               PASS_RTOL,
               SMOOTHER_FACTORS)
    P_sm, P_lag = tpf.qr_smoother_assemble(suf_t[2], Jt)
    smj = _jax_smoother(kj, pj)
    _close_all((suf_t[1], P_sm, P_lag), smj, PASS_RTOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("masked", [False, True])
def test_pit_qr_filter_smoother_past_10_matches_jax(k, masked):
    p, Y, W = _setup(k)
    Yz = np.where(W > 0, Y, 0.0) if masked else Y
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    kj, smj = _jax_filter_smoother(
        jnp.asarray(Yz), pj, jnp.asarray(W) if masked else None)
    kt, smt = tpf.pit_qr_filter_smoother(
        _t(Yz), pt, mask=_t(W) if masked else None)
    _close_all(kt, kj, PASS_RTOL)
    _close_all(smt, smj, PASS_RTOL)


def test_fit_pit_qr_at_k12_matches_jax():
    """Three EM iterations through ``fit(filter="pit_qr")`` at k = 12,
    masked, against the JAX fit: the E-step's generic branches in EM."""
    p, Y, W = _setup(12)
    Ym = np.where(W > 0, Y, np.nan)
    kw = dict(max_iters=3, tol=0.0)
    rj = jfit(JModel(12), Ym, backend=TPUBackend(dtype=np.float64,
                                                 filter="pit_qr"), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(12), Ym,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64,
                                          filter="pit_qr"), **kw)
    assert rt.filter == rj.filter == "pit_qr"
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=FIT_RTOL)
    for name in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, name), getattr(rj.params, name), FIT_RTOL)
    close(rt.factors, rj.factors, FIT_RTOL)


# The mixed-frequency pit_qr route: m = 15 (k = 3, the generic branches)
# and m = 5 (k = 1, the unrolled ones; at m = 10 the JAX package's jit of
# the unrolled scan takes minutes on the CPU).
MF_PANELS = {"m15": (20, 6, 3), "m5": (20, 6, 1)}


@functools.lru_cache(maxsize=None)
def _mf(pn):
    nm, nq, k = MF_PANELS[pn]
    rng = np.random.default_rng(7)
    Y, mask, _, _ = dgp.simulate_mixed_freq(nm, nq, 36, k, rng)
    W = mask * dgp.random_mask(36, nm + nq, rng, 0.1)
    W[11] = 0.0
    kw = dict(n_monthly=nm, n_quarterly=nq, n_factors=k, time_scan="pit_qr")
    return np.where(W > 0, Y, np.nan), W, jm.MixedFreqSpec(**kw), \
        tm.MixedFreqSpec(**kw)


@pytest.mark.parametrize("pn", MF_PANELS)
def test_mf_pit_qr_matches_jax(pn):
    from dfm_tpu.utils.data import build_mask, standardize
    Y, W, sj, st = _mf(pn)
    Wm = build_mask(Y, W)
    Ys, _ = standardize(Y, mask=Wm)
    Yz = np.nan_to_num(Ys * (Wm > 0))
    pj = jm.mf_pca_init(Ys, Wm, sj)
    with jax.default_matmul_precision("highest"):
        pj1, llj, _ = _jax_mf_core(jnp.asarray(Yz), jnp.asarray(Wm), pj, sj)
    pt1, llt, _ = tm.mf_em_core(_t(Yz), _t(Wm), tm.MFParams.from_numpy(pj),
                                st)
    np.testing.assert_allclose(float(llt), float(llj), rtol=FIT_RTOL)
    for name in tm.MFParams._fields:
        close(_np(getattr(pt1, name)), _np(getattr(pj1, name)), FIT_RTOL)
    # Chunks of one iteration: the JAX package compiles a 1-iteration
    # program instead of a 2-iteration one (the numbers do not depend on
    # the chunk).
    rj = jm.mf_fit(Y, sj, mask=W, max_iters=2, tol=0.0, fused_chunk=1)
    rt = dtt.fit(st, Y, mask=W, max_iters=2, tol=0.0,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64,
                                          fused_chunk=1))
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=FIT_RTOL)
    close(rt.nowcast, rj.nowcast, FIT_RTOL)
    for name in tm.MFParams._fields:
        close(_np(getattr(rt.params, name)), _np(getattr(rj.params, name)),
              FIT_RTOL)


def test_f32_pit_qr_past_10_no_worse_than_jax():
    """At k = 12 the f32 loglik of both packages' square-root filters
    carries the Gram branch's jitter; the port's is within twice the JAX
    package's distance from the f64 info filter."""
    p, Y, W = _setup(12)
    Yz = np.where(W > 0, Y, 0.0)
    ref = float(tif.info_filter(_t(Yz), TP.from_numpy(p), _t(W)).loglik)
    jax32 = float(jax.jit(jpf.pit_qr_filter)(
        jnp.asarray(Yz, jnp.float32), JP.from_numpy(p, jnp.float32),
        jnp.asarray(W, jnp.float32)).loglik)
    t32 = float(tpf.pit_qr_filter(
        torch.tensor(Yz, dtype=torch.float32),
        TP.from_numpy(p, dtype=torch.float32),
        mask=torch.tensor(W, dtype=torch.float32)).loglik)
    err_j, err_t = abs(jax32 - ref) / abs(ref), abs(t32 - ref) / abs(ref)
    assert np.isfinite(t32) and err_t <= 2.0 * max(err_j, 1e-7), \
        (err_t, err_j)


@pytest.mark.parametrize("op", list(tla.SMALL_LINALG_OPS))
def test_small_linalg_generic_ops_match_jax(op):
    """The unit mode's ops at k = 12 on the CPU are the JAX generic
    branches (tria: the jittered Gram Cholesky; tri_solve: a plain
    triangular solve; psd_factor: a jittered Cholesky; chol and
    chol_solve: psd_cholesky(., 0) and chol_solve)."""
    k = 12
    rng = np.random.default_rng(12)
    X = rng.standard_normal((4, k, 2 * k))
    P = X @ np.swapaxes(X, -1, -2)
    L = np.linalg.cholesky(P)
    B = rng.standard_normal((4, k, k))
    jfn = {"chol": lambda: jla.psd_cholesky(jnp.asarray(P), jitter=0.0),
           "chol_solve": lambda: jla.chol_solve(jnp.asarray(L),
                                                jnp.asarray(B)),
           "tria": lambda: jla.tria(jnp.asarray(X)),
           "tri_solve": lambda: jla.tri_solve(jnp.asarray(L),
                                              jnp.asarray(B)),
           "tri_solve_trans": lambda: jla.tri_solve(
               jnp.asarray(L), jnp.asarray(B), trans=True),
           "psd_factor": lambda: jla.psd_factor(jnp.asarray(P))}[op]
    Xin = X if op == "tria" else (L if op in ("chol_solve", "tri_solve",
                                              "tri_solve_trans") else P)
    got = tla.small_linalg(op, _t(Xin), _t(B))
    close(got.numpy(), np.asarray(jfn()), PASS_RTOL)


def test_qr_route_past_10_and_its_raise_at_129():
    """k <= 10: the one-thread kernels; 10 < k <= 128: the generic ones
    (registered, with a workspace size); 129 raises naming the ROADMAP
    row before any launch, also on "meta" tensors through the wrappers."""
    for name in ("qr_elements", "qr_scan"):
        assert tla.check_qr_k(name, 10) == name
        for k in (11, 64, kernels.GEN_KMAX):
            gen = tla.check_qr_k(name, k)
            assert gen == f"{name}_gen"
            assert kernels.KERNELS[gen][0] == kernels.KERNELS[
                name.replace("qr_", "pit_")][0]
            assert kernels.GEN_MATS[gen] > 0
        with pytest.raises(NotImplementedError, match=kernels.GENERIC_K):
            tla.check_qr_k(name, kernels.GEN_KMAX + 1)
    k = kernels.GEN_KMAX + 1
    meta = dict(device="meta", dtype=torch.float32)
    mats, vecs = torch.zeros((5, k, k), **meta), torch.zeros((5, k), **meta)
    eye, v0 = torch.zeros((k, k), **meta), torch.zeros(k, **meta)
    st = tif.ObsStats(vecs, mats, torch.zeros(5, **meta),
                      torch.zeros(5, **meta))
    kf = tpf.FilterResult(vecs, mats, vecs, mats, None)
    kernels.reset_launches()
    for call in (lambda: tpf.qr_filter_elements(st, eye, eye, v0, eye),
                 lambda: tpf.qr_scan((mats, vecs, mats, vecs, mats)),
                 lambda: tpf.qr_filter_assemble(vecs, mats, mats, eye, eye,
                                                v0, eye),
                 lambda: tpf.qr_smoother_elements(kf, eye, eye),
                 lambda: tpf.qr_scan((mats, vecs, mats), True),
                 lambda: tpf.qr_smoother_assemble(mats, mats[:4]),
                 lambda: tla.small_linalg("chol", mats)):
        with pytest.raises(NotImplementedError, match=kernels.GENERIC_K):
            call()
    assert sum(kernels.LAUNCHES.values()) == 0


# ------------------------------------- ROADMAP Queue 3, faults 1-3 ---

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bs", [1, 4, 5, 23, 40])
def test_blocked_scan_takes_block_size_like_jax(bs, reverse):
    """Fault 1: the JAX signature (combine, elems, block_size, reverse);
    ``block_size`` passed positionally, as a JAX-shaped call does."""
    rng = np.random.default_rng(52)
    Ms = rng.standard_normal((23, 3, 3)) * 0.5
    want = jsc.blocked_scan(lambda a, b: a @ b, jnp.asarray(Ms),
                            block_size=bs, reverse=reverse)
    got = tsc.blocked_scan(lambda a, b: a @ b, _t(Ms), bs, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_pca_inits_take_dtype_and_host_arrays():
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((3, 50, 30))
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    pj = jinit.pca_init_device(Y[0], 2, dtype=jnp.float64)
    pt = tinit.pca_init_device(Y[0], 2, dtype=torch.float64, device="cpu")
    s = np.sign(np.sum(pt.Lam * pj.Lam, axis=0))
    close(pt.Lam * s, pj.Lam, PASS_RTOL)
    close(pt.R, pj.R, PASS_RTOL)
    for got, want in zip(tinit.pca_init_batched(Y, 2, dtype=torch.float64,
                                                device="cpu"),
                         jinit.pca_init_batched(Y, 2, dtype=jnp.float64)):
        s = np.sign(np.sum(got.Lam * want.Lam, axis=0))
        close(got.Lam * s, want.Lam, PASS_RTOL)
        close(np.diag(s) @ got.A @ np.diag(s), want.A, PASS_RTOL)


def test_accum_dtype_takes_the_jax_arguments():
    for native_only in (False, True):
        assert jnp.dtype(jprec.accum_dtype(jnp.float32, native_only)) == \
            jnp.float64
        assert tprec.accum_dtype(torch.float32, native_only) == \
            torch.float64
    assert tprec.accum_dtype() == torch.float64


def test_tvl_round_scan_takes_has_mask():
    """Seven positional arguments, as the JAX package's; has_mask=False
    drops the mask."""
    rng = np.random.default_rng(4)
    T_, N_, k = 30, 12, 2
    Y, _, Lams, _, _ = dgp.simulate_tv_loadings(N_, T_, k, rng)
    Y = (Y - Y.mean(0)) / Y.std(0)
    W = np.ones_like(Y)
    W[rng.random(Y.shape) < 0.1] = 0.0
    Yz = np.where(W > 0, Y, 0.0)
    p0 = jcpu.pca_init(Yz, k, mask=W)
    kw = dict(n_factors=k, n_rounds=2)
    Lam0 = np.broadcast_to(p0.Lam, (T_, N_, k)).copy()
    init = dict(Lam0=p0.Lam, tau2=np.full(N_, 1e-3), A=p0.A, Q=p0.Q, R=p0.R,
                mu0=p0.mu0, P0=p0.P0)
    pj = jtv.TVLParams(**{n: jnp.asarray(v) for n, v in init.items()})
    pt = ttv.TVLParams(**{n: _t(v) for n, v in init.items()})
    for has_mask in (True, False):
        (Lj, qj), llj = jtv.tvl_round_scan(
            jnp.asarray(Yz), jnp.asarray(W), jnp.asarray(Lam0), pj,
            jtv.TVLSpec(**kw), has_mask, 2)
        (Lt, qt), llt = ttv.tvl_round_scan(
            _t(Yz), _t(W), _t(Lam0), pt, ttv.TVLSpec(**kw), has_mask, 2)
        np.testing.assert_allclose(llt.numpy(), np.asarray(llj),
                                   rtol=FIT_RTOL)
        close(Lt.numpy(), np.asarray(Lj), FIT_RTOL)


def test_chol_small_takes_jitter():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((3, 4, 6))
    M = X @ np.swapaxes(X, -1, -2)
    close(tla.chol_small(_t(M), jitter=0.5).numpy(),
          np.asarray(jla.chol_small(jnp.asarray(M), jitter=0.5)), PASS_RTOL)


def test_health_from_trace_takes_max_ss_delta():
    lls = [-10.0, -9.0, -9.5, float("nan")]
    hj = jhealth.health_from_trace(lls, noise_floor=0.1, max_ss_delta=3e-4)
    ht = thealth.health_from_trace(lls, noise_floor=0.1, max_ss_delta=3e-4)
    assert ht.max_ss_delta == hj.max_ss_delta == 3e-4
    assert ht.monotonicity_violations == hj.monotonicity_violations == 1
    assert len(ht.events) == len(hj.events) == 1


def test_runs_dir_takes_ambient_only(monkeypatch, tmp_path):
    monkeypatch.delenv("DFM_RUNS", raising=False)
    for kw in ({}, {"ambient_only": True}):
        assert tstore.runs_dir(**kw) == jstore.runs_dir(**kw)
        assert tstore.runs_dir(str(tmp_path), **kw) == \
            jstore.runs_dir(str(tmp_path), **kw)
    assert tstore.runs_dir(ambient_only=True) is None
    monkeypatch.setenv("DFM_RUNS", str(tmp_path))
    assert tstore.runs_dir(ambient_only=True) == \
        jstore.runs_dir(ambient_only=True) == str(tmp_path)


def test_params_host_takes_out_p():
    """``FleetBucket.params_host(out_p=)``: the given stacked params, not
    the resident ones (the method on a stand-in bucket)."""
    rng = np.random.default_rng(6)
    ps = [jcpu.SSMParams(rng.standard_normal((5, 2)), np.eye(2) * 0.5,
                         np.eye(2), np.ones(5), np.zeros(2), np.eye(2) * b)
          for b in (1.0, 2.0)]
    resident = list(reversed(ps))
    got = tbuf.FleetBucket.params_host(
        types.SimpleNamespace(p=tbat.stack_params(resident)),
        out_p=tbat.stack_params(ps))
    want = jbuf.FleetBucket.params_host(
        types.SimpleNamespace(p=jbat.stack_params(resident, jnp.float64)),
        out_p=jbat.stack_params(ps, jnp.float64))
    for g, w in zip(got, want):
        for name in ("Lam", "A", "Q", "R", "mu0", "P0"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
    np.testing.assert_array_equal(got[1].P0, ps[1].P0)


# Stops the k = 2 fit below inside its second chunk of 3 (relative steps
# 1.0e-2, 1.3e-3, 8.6e-4: the stop at the 4th loglik).
TOL_STOP = 1e-3


def test_run_em_chunked_takes_the_jax_signature():
    """``run_em_chunked(scan_fn, p0, max_iters, tol, noise_floor, ...)``
    with a JAX-shaped scan_fn: a mid-chunk stop replays to the update
    count the stopping rule chose, as the JAX driver does."""
    p, Y, W = _setup(12)
    Yz = np.where(W > 0, Y, 0.0)
    Yz = np.where(W > 0, (Yz - Yz.mean(0)) / Yz.std(0), 0.0)
    p0 = jcpu.pca_init(Yz, 2, mask=W)
    cfg_j, cfg_t = jem.EMConfig(filter="info"), tem.EMConfig(filter="info")
    Yj, Wj, Yt, Wt = (jnp.asarray(Yz), jnp.asarray(W), _t(Yz), _t(W))

    def scan_j(pp, n):
        return jem.em_fit_scan(Yj, pp, n, mask=Wj, cfg=cfg_j)[:2] + (None,)

    def scan_t(pp, n):
        ps, lls, _ = tem.em_fit_scan(Yt, pp, n, mask=Wt, cfg=cfg_t)
        return ps[-1], lls, None

    seen = []
    floor = jem.noise_floor_for(jnp.float64, Yj.size)
    pj, llj, cj, ij = jem.run_em_chunked(
        scan_j, JP.from_numpy(p0, jnp.float64), 40, TOL_STOP, floor,
        fused_chunk=3)
    pt, llt, ct, it = tem.run_em_chunked(
        scan_t, TP.from_numpy(p0), 40, TOL_STOP, floor,
        callback=lambda i, ll, pe: seen.append(i), fused_chunk=3)
    assert (ct, it, len(llt)) == (cj, ij, len(llj))
    assert ct and it % 3 != 0                  # a mid-chunk stop
    assert seen == list(range(len(llt)))
    np.testing.assert_allclose(llt, np.asarray(llj), rtol=FIT_RTOL)
    for g, w in zip(pt, pj):
        close(g.numpy(), np.asarray(w), FIT_RTOL)


def _unported_calls():
    """(label, call, item) for every keyword of fault 3."""
    Y = np.zeros((20, 6))
    model = dtt.DynamicFactorModel(1)
    fit_kw = (("callback", print, 3), ("checkpoint_path", "ck", 3),
              ("checkpoint_every", 5, 3), ("debug", True, 3),
              ("robust", True, 5), ("telemetry", True, 3),
              ("progress", print, 3), ("pipeline", 2, 4), ("auto", True, 3),
              ("tune", {"grid": 3}, 9))
    out = [(f"fit-{kw}", functools.partial(dtt.fit, model, Y,
                                           backend=CPU, **{kw: v}), item)
           for kw, v, item in fit_kw]
    out.append(("fit_many-robust", functools.partial(
        tbat.fit_many, None, robust=True), 5))
    for kw, item in (("policy", 5), ("scan_impl", 12), ("state0", 12),
                     ("scan_impl_metrics", 12), ("scan_impl_capped", 12),
                     ("scan_impl_capped_metrics", 12)):
        out.append((f"run_batched_em-{kw}", functools.partial(
            tbat.run_batched_em, None, None, None, 1, 0.0,
            **{kw: object()}), item))
    out += [("em_fit_scan-with_metrics", functools.partial(
                tem.em_fit_scan, None, None, 1, with_metrics=True), 3),
            ("em_fit_scan-n_active", functools.partial(
                tem.em_fit_scan, None, None, 1, n_active=1), 4)]
    for kw in ("policy", "health", "p0_host"):
        out.append((f"run_fused-{kw}", functools.partial(
            tfused.run_fused, None, None, None, None, 1, 0.0, 0.0, None,
            **{kw: object()}), 5))
    for fn, args in ((tm.mf_em_core, (None,) * 4),
                     (ttv.factor_pass_tv, (None,) * 3),
                     (ttv.tvl_round_core, (None,) * 5)):
        out.append((f"{fn.__name__}-reduce_tree", functools.partial(
            fn, *args, reduce_tree=lambda x: x), 12))
    for fn, args in ((tsv.sv_fit, (Y, None)), (tsv.sv_filter, (None,) * 3),
                     (tsv.sv_smooth_h, (None, None))):
        out.append((f"{fn.__name__}-key", functools.partial(
            fn, *args, key=jax.random.PRNGKey(0)), None))
    return out


@pytest.mark.parametrize("label,call,item", _unported_calls(),
                         ids=[c[0] for c in _unported_calls()])
def test_unported_keywords_raise_naming_their_item(label, call, item):
    """Fault 3: a keyword the JAX function takes for work not ported yet
    raises NotImplementedError naming its ROADMAP Queue 1 item (the SV
    ``key``: saying to pass generator= or draws=), not TypeError."""
    match = (f"ROADMAP Queue 1 item {item}\\b" if item is not None
             else "generator=.*draws=")
    with pytest.raises(NotImplementedError, match=match):
        call()
