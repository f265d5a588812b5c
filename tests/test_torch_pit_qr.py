"""dfm_tpu_torch's square-root parallel-in-time engine (pit_qr) and its
small linear algebra against dfm_tpu.

- The K6/K7 twins (``ops.linalg``) run the JAX package's scalar
  algorithms in the same order: 1e-12 relative, with each edge contract
  (NaN on an indefinite Cholesky, zero rows in ``tria``, zero pivots in
  ``tri_solve``, a rank-deficient ``psd_factor``).
- ``blocked_scan`` and ``affine_const_prefix`` (``ops.scan``) at lengths
  divisible and not divisible by the block size: 1e-12.
- ``pit_qr_filter`` / ``pit_qr_smoother`` against the JAX pair at the
  tolerances of tests/test_pit_qr.py (its pit_qr-vs-sequential bounds),
  and the EM path through pit_qr at 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.backends import cpu_ref as jcpu
from dfm_tpu.estim import em as jem
from dfm_tpu.ops import linalg as jla
from dfm_tpu.ops import scan as jsc
from dfm_tpu.ssm import info_filter as jif
from dfm_tpu.ssm import parallel_filter as jpf
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels as tkern
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.ops import linalg as tla
from dfm_tpu_torch.ops import scan as tsc
from dfm_tpu_torch.ssm import info_filter as tif
from dfm_tpu_torch.ssm import parallel_filter as tpf
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-12


def _psd(rng, n, k, rank=None):
    X = rng.standard_normal((n, k, rank or k))
    return X @ np.swapaxes(X, -1, -2)


def _lower(rng, n, k):
    L = np.tril(rng.standard_normal((n, k, k)))
    idx = np.arange(k)
    L[:, idx, idx] = np.abs(L[:, idx, idx]) + 0.5
    return L


def _pair(fn_j, fn_t, *arrays, **kw):
    got = fn_t(*(torch.tensor(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_chol_and_solve_twins(k):
    rng = np.random.default_rng(k)
    P = _psd(rng, 6, k) + np.eye(k)
    B = rng.standard_normal((6, k, 4))
    P[0] = -P[0]                                  # indefinite: NaN
    got, want = _pair(jla.chol_unrolled, tla.chol_unrolled, P)
    assert np.isnan(got[0]).any() and np.isnan(want[0]).any()
    close(got[1:], want[1:], RTOL)
    L = want[1:]
    close(*_pair(jla.chol_solve_unrolled, tla.chol_solve_unrolled, L, B[1:]),
          RTOL)
    close(*_pair(jla.chol_solve_unrolled, tla.chol_solve_unrolled, L,
                 B[1:, :, 0]), RTOL)
    close(*_pair(jla.matmul_vpu, tla.matmul_vpu, P, B), RTOL)
    close(*_pair(jla.matvec_vpu, tla.matvec_vpu, P, B[..., 0]), RTOL)


@pytest.mark.parametrize("k", [1, 3, 10, 12])
def test_tria_tri_solve_psd_factor_twins(k):
    """k = 12 takes the generic branches above QR_UNROLL_K_MAX."""
    rng = np.random.default_rng(100 + k)
    X = rng.standard_normal((5, k, 2 * k))
    X[1, k // 2] = 0.0                            # a zero row
    X[2] = 0.0                                    # all rows zero
    if k <= tla.QR_UNROLL_K_MAX:
        got, want = _pair(jla.tria, tla.tria, X)
        close(got, want, RTOL)
        assert np.all(got[2] == 0.0) and np.all(got[1][k // 2] == 0.0)
    else:
        got, want = _pair(jla.tria, tla.tria, X[3:])
        close(got, want, 1e-10)
    L = _lower(rng, 5, k)
    if k > 1:
        L[1, 1, 1] = 0.0                          # a zero pivot
        L[1, 2:, 1] = 0.0
    B = rng.standard_normal((5, k, 3))
    for trans in (False, True):
        Lin = L if k <= tla.QR_UNROLL_K_MAX else L[2:]
        Bin = B if k <= tla.QR_UNROLL_K_MAX else B[2:]
        got, want = _pair(jla.tri_solve, tla.tri_solve, Lin, Bin,
                          trans=trans)
        close(got, want, RTOL)
    if k <= tla.QR_UNROLL_K_MAX:
        P = _psd(rng, 4, k, rank=max(k - 2, 1))   # rank-deficient
        P[1] = 0.0
        got, want = _pair(jla.psd_factor, tla.psd_factor, P)
        close(got, want, RTOL)
        assert np.all(got[1] == 0.0) and np.isfinite(got).all()
    else:                   # the generic branch: a jittered Cholesky
        P = _psd(rng, 4, k) + np.eye(k)
        close(*_pair(jla.psd_factor, tla.psd_factor, P), 1e-10)


def test_small_linalg_unit_mode_runs_the_twins_on_cpu():
    rng = np.random.default_rng(7)
    X = torch.as_tensor(rng.standard_normal((4, 3, 6)))
    assert torch.equal(tla.small_linalg("tria", X), tla.tria_unrolled(X))
    L = torch.as_tensor(_lower(rng, 4, 3))
    B = torch.as_tensor(rng.standard_normal((4, 3, 3)))
    assert torch.equal(tla.small_linalg("tri_solve_trans", L, B),
                       tla.tri_solve_unrolled(L, B, trans=True))
    assert tla.check_qr_k("qr_scan", tla.QR_UNROLL_K_MAX) == "qr_scan"
    assert tla.check_qr_k("qr_scan", tla.QR_UNROLL_K_MAX + 1) == \
        "qr_scan_gen"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tla.check_qr_k("qr_scan", tkern.GEN_KMAX + 1)


@pytest.mark.parametrize("T,reverse", [(16, False), (29, False), (29, True),
                                       (1, False), (50, True)])
def test_blocked_scan_twin(T, reverse):
    """T = 16 splits into 4 blocks of 4; 29 and 50 leave a remainder."""
    rng = np.random.default_rng(T)
    M = 0.4 * rng.standard_normal((T, 3, 3))
    d = rng.standard_normal((T, 3))

    def comb_t(e, l):
        return (l[0] @ e[0], torch.einsum("...kl,...l->...k", l[0], e[1])
                + l[1])

    want = jsc.blocked_scan(
        lambda e, l: (l[0] @ e[0],
                      jnp.einsum("...kl,...l->...k", l[0], e[1]) + l[1]),
        (jnp.asarray(M), jnp.asarray(d)), reverse=reverse)
    got = tsc.blocked_scan(comb_t, (torch.as_tensor(M), torch.as_tensor(d)),
                           reverse=reverse)
    for g, w in zip(got, want):
        close(g, w, RTOL)


@pytest.mark.parametrize("n", [1, 7, 64, 100])
def test_affine_const_prefix_and_affine_scan_twins(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((4, 4)) * 0.3
    d = rng.standard_normal((n, 4))
    x0 = rng.standard_normal(4)
    close(*_pair(jsc.affine_const_prefix, tsc.affine_const_prefix, M, d, x0),
          RTOL)
    # The exact-head + constant-tail recursion, forward and reversed,
    # against a plain loop.
    T, h = n + 1, min(5, n)
    Mh = rng.standard_normal((h, 4, 4)) * 0.3
    dd = rng.standard_normal((T, 4))
    for reverse in (False, True):
        x = np.empty((T, 4))
        order = range(T - 2, -1, -1) if reverse else range(1, T)
        x[T - 1 if reverse else 0] = x0
        for t in order:
            Mt = Mh[t] if t < h else M
            x[t] = Mt @ x[t + 1 if reverse else t - 1] + dd[t]
        got = tsc.affine_scan(*(torch.as_tensor(a) for a in (dd, Mh, M, x0)),
                              reverse=reverse)
        close(got, x, RTOL)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(61)
    p = dgp.dfm_params(33, 3, rng)
    Y, _ = dgp.simulate(p, 90, rng)
    W = dgp.random_mask(*Y.shape, np.random.default_rng(62), 0.3)
    W[5] = 0.0                                    # a fully missing step
    W[9] = 0.0
    W[9, :2] = 1.0                                # fewer than k observed
    return p, Y, W


@pytest.mark.parametrize("masked", [False, True])
def test_pit_qr_filter_smoother_matches_jax(setup, masked):
    p, Y, W = setup
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    kj, smj = jpf.pit_qr_filter_smoother(
        jnp.asarray(Y), pj, mask=jnp.asarray(W) if masked else None)
    kt, smt = tpf.pit_qr_filter_smoother(
        torch.as_tensor(Y), pt, mask=torch.as_tensor(W) if masked else None)
    assert abs(float(kt.loglik) - float(kj.loglik)) < 1e-7 * abs(
        float(kj.loglik))
    for name in ("x_filt", "P_filt", "x_pred", "P_pred"):
        np.testing.assert_allclose(getattr(kt, name), getattr(kj, name),
                                   atol=1e-9)
    for name in ("x_sm", "P_sm", "P_lag"):
        np.testing.assert_allclose(getattr(smt, name), getattr(smj, name),
                                   atol=1e-8)


def test_em_through_pit_qr_matches_jax(setup):
    p, Y, W = setup
    Yz = np.where(W > 0, (Y - Y.mean(0)) / Y.std(0), 0.0)
    p0 = jcpu.pca_init(Yz, 3, mask=W)
    pj, lls_j, _ = jem.em_fit_scan(
        jnp.asarray(Yz), JP.from_numpy(p0, jnp.float64), 3,
        mask=jnp.asarray(W), cfg=jem.EMConfig(filter="pit_qr"))
    ps, lls_t, _ = tem.em_fit_scan(
        torch.as_tensor(Yz), TP.from_numpy(p0), 3, mask=torch.as_tensor(W),
        cfg=tem.EMConfig(filter="pit_qr"))
    np.testing.assert_allclose(lls_t.numpy(), np.asarray(lls_j), rtol=1e-9)
    for g, w in zip(ps[-1], pj):
        close(g, w, 1e-9)


@pytest.mark.parametrize("scan_impl", ["blocked", "associative"])
def test_pit_qr_functions_take_scan_impl(setup, scan_impl):
    """``pit_qr_from_stats``, ``pit_qr_filter`` and ``pit_qr_smoother``
    take ``scan_impl`` as their JAX twins do: "blocked" and "associative"
    give the twins' answers."""
    p, Y, W = setup
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    Yt, Wt = torch.as_tensor(Y), torch.as_tensor(W)
    st = tif.obs_stats(Yt, pt.Lam, pt.R, mask=Wt)
    sj = jif.obs_stats(jnp.asarray(Y), pj.Lam, pj.R, mask=jnp.asarray(W))
    for got, want in zip(tpf.pit_qr_from_stats(st, pt, scan_impl),
                         jpf.pit_qr_from_stats(sj, pj, scan_impl)):
        np.testing.assert_allclose(got, want, atol=1e-9)
    kj = jpf.pit_qr_filter(jnp.asarray(Y), pj, mask=jnp.asarray(W),
                           scan_impl=scan_impl)
    kt = tpf.pit_qr_filter(Yt, pt, mask=Wt, scan_impl=scan_impl)
    assert abs(float(kt.loglik) - float(kj.loglik)) < 1e-7 * abs(
        float(kj.loglik))
    smj = jpf.pit_qr_smoother(kj, pj, scan_impl=scan_impl)
    smt = tpf.pit_qr_smoother(kt, pt, scan_impl=scan_impl)
    for name in ("x_sm", "P_sm", "P_lag"):
        np.testing.assert_allclose(getattr(smt, name), getattr(smj, name),
                                   atol=1e-8)
