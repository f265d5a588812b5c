"""dfm_tpu_torch.ssm against the dfm_tpu.ssm twins and the NumPy oracle.

The same numpy-seeded panel (N = 37, T = 80, k = 3, AR(1)) goes through
the JAX function at x64 and its port in float64 on the CPU, where every
kernel wrapper runs its plain-torch version.  Single passes agree to
1e-10 relative (the two frameworks order their sums differently; the
recursions stay at ~1e-13 in practice).  The masked panel has 25%
scattered missing values with NaN at masked entries and one fully missing
time step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.backends import cpu_ref as jcpu
from dfm_tpu.ssm import info_filter as jif
from dfm_tpu.ssm import kalman as jk
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.ssm import info_filter as tif
from dfm_tpu_torch.ssm import kalman as tk
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-10


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(7)
    p = dgp.dfm_params(37, 3, rng)
    Y, _ = dgp.simulate(p, 80, rng)
    W = (rng.random(Y.shape) >= 0.25).astype(np.float64)
    W[5] = 0.0                                  # a fully missing time step
    return p, Y, W, np.where(W > 0, Y, np.nan)


def _inputs(panel, masked):
    p, Y, W, Ynan = panel
    if masked:
        return (p, jnp.asarray(Ynan), jnp.asarray(W), torch.as_tensor(Ynan),
                torch.as_tensor(W))
    return p, jnp.asarray(Y), None, torch.as_tensor(Y), None


@pytest.mark.parametrize("masked", [False, True])
def test_obs_stats(panel, masked):
    p, Yj, Wj, Yt, Wt = _inputs(panel, masked)
    sj = jif.obs_stats(Yj, jnp.asarray(p.Lam), jnp.asarray(p.R), mask=Wj)
    st = tif.obs_stats(Yt, torch.as_tensor(p.Lam), torch.as_tensor(p.R),
                       mask=Wt)
    for got, want in zip(st, sj):
        assert tuple(got.shape) == tuple(want.shape)
        close(got, want, RTOL)
    if masked:
        assert float(st.n[5]) == 0.0 and float(st.ldR[5]) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_info_scan_and_quad_local(panel, masked):
    p, Yj, Wj, Yt, Wt = _inputs(panel, masked)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    sj = jif.obs_stats(Yj, pj.Lam, pj.R, mask=Wj)
    st = tif.obs_stats(Yt, pt.Lam, pt.R, mask=Wt)
    outs_j = jif.info_scan(sj, pj.A, pj.Q, pj.mu0, pj.P0)
    outs_t = tif.info_scan(st, pt.A, pt.Q, pt.mu0, pt.P0)
    for got, want in zip(outs_t, outs_j):
        close(got, want, RTOL)
    qj, _ = jif.quad_local(Yj, pj.Lam, pj.R, outs_j[0], Wj)
    qt = tif.quad_local(Yt, pt.Lam, pt.R, outs_t[0], Wt)
    assert qt.dtype == torch.float64
    close(qt, qj, RTOL)
    close(tif.u_from_stats(st, outs_t[0]), jif.u_from_stats(sj, outs_j[0]), RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_info_filter_and_smoother(panel, masked):
    p, Yj, Wj, Yt, Wt = _inputs(panel, masked)
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    kj = jif.info_filter(Yj, pj, mask=Wj)
    kt = tif.info_filter(Yt, pt, mask=Wt)
    for got, want in zip(kt, kj):
        close(got, want, RTOL)
    smj = jk.rts_smoother(kj, pj)
    smt = tk.rts_smoother(kt, pt)
    for got, want in zip(smt, smj):
        close(got, want, RTOL)
    assert float(smt.P_lag[0].abs().max()) == 0.0
    # The NumPy oracles: dense and information form.
    W = panel[2] if masked else None
    Y = panel[1]
    for oracle in (jcpu.kalman_filter, jcpu.kalman_filter_info):
        ll = oracle(Y, p, mask=W).loglik
        assert abs(float(kt.loglik) - ll) <= RTOL * abs(ll)
    x_sm, P_sm = tif.smooth(Yt, pt, mask=Wt)
    close(x_sm, smj.x_sm, RTOL)
    close(P_sm, smj.P_sm, RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_dense_kalman_filter(panel, masked):
    p, Yj, Wj, Yt, Wt = _inputs(panel, masked)
    kj = jk.kalman_filter(Yj, JP.from_numpy(p, jnp.float64), mask=Wj)
    kt = tk.kalman_filter(Yt, TP.from_numpy(p), mask=Wt)
    for got, want in zip(kt, kj):
        close(got, want, RTOL)
    ll = jcpu.kalman_filter(panel[1], p, mask=panel[2] if masked else None)
    assert abs(float(kt.loglik) - ll.loglik) <= RTOL * abs(ll.loglik)


@pytest.mark.parametrize("masked", [False, True])
def test_loglik_eval_on_cpu(panel, masked):
    p, Y, W, Ynan = panel
    want = float(jif.loglik_eval(Ynan if masked else Y, p,
                                 mask=W if masked else None))
    got = tif.loglik_eval(torch.as_tensor(Ynan if masked else Y), p,
                          mask=W if masked else None)
    assert abs(got - want) <= RTOL * abs(want)
    got_np = tif.loglik_eval(Ynan if masked else Y, p,
                             mask=W if masked else None, device="cpu")
    assert got_np == got


def test_params_cross_from_either_numpy_container(panel):
    p = panel[0]
    a = TP.from_numpy(p)
    b = TP.from_numpy(JP.from_numpy(p, jnp.float64).to_numpy())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # A transposed (non-contiguous) NumPy input still gives the contiguous
    # tensors the kernels take.
    p_t = type(p)(p.Lam, np.ascontiguousarray(p.A.T).T, p.Q, p.R, p.mu0, p.P0)
    assert not p_t.A.flags.c_contiguous
    assert all(x.is_contiguous() for x in TP.from_numpy(p_t))
    back = a.to_numpy()
    assert type(back).__module__ == "dfm_tpu_torch.backends.cpu_ref"
    np.testing.assert_array_equal(back.Lam, p.Lam)


def test_cpu_wrappers_never_launch(panel):
    kernels.reset_launches()
    p, Yj, Wj, Yt, Wt = _inputs(panel, True)
    kt = tif.info_filter(Yt, TP.from_numpy(p), mask=Wt)
    tk.rts_smoother(kt, TP.from_numpy(p))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
