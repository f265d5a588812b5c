"""dfm_tpu_torch.ssm.steady (the ss engine) against dfm_tpu.ssm.steady.

Single passes compare at 1e-10 relative at the same tau (same algebra in
another order of additions: the measured gap is ~1e-15).  The EM path
compares at 1e-9 (three iterations carry each pass's rounding into the
next params).  The f32 loglik, which takes the expanded quadratic
(``quad_expanded``) because the f64 accumulator is wider than f32, is
held to the 1e-5 relative loglik contract against the JAX package's f32
value: both sit ~1e-7 from the f64 loglik, so 1e-5 leaves margin.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.backends import cpu_ref as jcpu
from dfm_tpu.estim import em as jem
from dfm_tpu.ssm import steady as jss
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.ssm import info_filter as tif
from dfm_tpu_torch.ssm import steady as tss
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-10
TAU = 16


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(61)
    p = dgp.dfm_params(35, 3, rng)
    Y, _ = dgp.simulate(p, 120, rng)
    return p, Y


def _both(p, Y, tau, mask=None):
    j = jss.ss_filter_smoother(jnp.asarray(Y), JP.from_numpy(p, jnp.float64),
                               tau=tau,
                               mask=None if mask is None else jnp.asarray(mask))
    t = tss.ss_filter_smoother(torch.as_tensor(Y), TP.from_numpy(p), tau=tau,
                               mask=None if mask is None
                               else torch.as_tensor(mask))
    return j, t


def test_ss_filter_smoother_matches_jax(setup):
    p, Y = setup
    (kj, smj, dj), (kt, smt, dtt) = _both(p, Y, TAU)
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik), rtol=RTOL)
    for name in ("x_pred", "P_pred", "x_filt", "P_filt"):
        close(getattr(kt, name), getattr(kj, name), RTOL)
    for name in ("x_sm", "P_sm", "P_lag"):
        close(getattr(smt, name), getattr(smj, name), RTOL)
    assert float(dtt) == pytest.approx(float(dj), abs=1e-15)


def test_ss_filter_and_ss_smoother_are_the_halves_of_the_pair(setup):
    p, Y = setup
    Yt, pt = torch.as_tensor(Y), TP.from_numpy(p)
    kf, sm, _ = tss.ss_filter_smoother(Yt, pt, tau=TAU)
    assert torch.equal(tss.ss_filter(Yt, pt, tau=TAU).x_filt, kf.x_filt)
    assert torch.equal(tss.ss_smoother(Yt, pt, tau=TAU).P_sm, sm.P_sm)


@pytest.mark.parametrize("case", ["masked", "short_T", "tau_below_1"])
def test_ss_fallbacks_to_the_exact_pair(setup, case):
    p, Y = setup
    mask, tau = None, TAU
    if case == "masked":
        mask = dgp.random_mask(*Y.shape, np.random.default_rng(63), 0.2)
    elif case == "short_T":
        Y = Y[: 2 * TAU + 4]
    else:
        tau = 0
    (kj, smj, _), (kt, smt, dtt) = _both(p, Y, tau, mask)
    assert float(dtt) == 0.0
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik), rtol=RTOL)
    close(smt.x_sm, smj.x_sm, RTOL)
    # The fallback is the exact info pair itself.
    exact = tif.info_filter(torch.as_tensor(Y), TP.from_numpy(p),
                            mask=None if mask is None
                            else torch.as_tensor(mask))
    assert float(kt.loglik) == float(exact.loglik)


def test_tau_helpers_give_the_jax_integers(setup):
    p, _ = setup
    rng = np.random.default_rng(5)
    slow = dgp.dfm_params(20, 2, rng, spectral_radius=0.95)
    for q in (p, slow):
        assert (tss.riccati_mixing_steps(q)
                == jss.riccati_mixing_steps(q))
        for kw in ({}, {"lo": 16}, {"margin": 1e6}, {"margin": 3.0}):
            assert tss.auto_tau(q, **kw) == jss.auto_tau(q, **kw)
        for cur in (8, 24, 192):
            assert tss.remeasure_tau(q, cur) == jss.remeasure_tau(q, cur)


def test_slow_mixing_delta_and_warning():
    """Near-unit-root dynamics with weak data: at tau = 8 the freeze
    delta is large, matches the JAX one, and ``warn_ss_delta`` fires above
    its threshold only."""
    rng = np.random.default_rng(64)
    p = jcpu.SSMParams(0.05 * np.ones((1, 1)), 0.9995 * np.eye(1),
                       1e-3 * np.eye(1), np.array([100.0]), np.zeros(1),
                       5.0 * np.eye(1))
    Y, _ = dgp.simulate(p, 300, rng)
    (_, _, dj), (_, _, dtt) = _both(p, Y, 8)
    assert float(dtt) > 1e-6
    np.testing.assert_allclose(float(dtt), float(dj), rtol=RTOL)
    with pytest.warns(RuntimeWarning, match="steady-state"):
        tem.warn_ss_delta(float(dtt) * 1e3, tau=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tem.warn_ss_delta(1e-6, tau=8)


def test_em_through_ss_matches_jax(setup):
    p, Y = setup
    Yz = (Y - Y.mean(0)) / Y.std(0)
    p0 = jcpu.pca_init(Yz, 3)
    pj, lls_j, dj = jem.em_fit_scan(jnp.asarray(Yz), JP.from_numpy(
        p0, jnp.float64), 3, cfg=jem.EMConfig(filter="ss", tau=TAU))
    ps, lls_t, dtt = tem.em_fit_scan(torch.as_tensor(Yz), TP.from_numpy(p0),
                                     3, cfg=tem.EMConfig(filter="ss",
                                                         tau=TAU))
    np.testing.assert_allclose(lls_t.numpy(), np.asarray(lls_j), rtol=1e-9)
    for g, w in zip(ps[-1], pj):
        close(g, w, 1e-9)
    np.testing.assert_allclose(dtt.numpy(), np.asarray(dj), atol=1e-14)


def test_f32_ss_loglik_takes_the_expanded_quadratic(setup):
    p, Y = setup
    Y32 = Y.astype(np.float32)
    sumsq_j = jnp.asarray(Y32) * jnp.asarray(Y32)
    kj, _, _ = jss.ss_filter_smoother(jnp.asarray(Y32),
                                      JP.from_numpy(p, jnp.float32),
                                      tau=TAU, sumsq=sumsq_j)
    Yt = torch.as_tensor(Y32)
    kt, _, _ = tss.ss_filter_smoother(Yt, TP.from_numpy(p, torch.float32),
                                      tau=TAU, sumsq=Yt * Yt)
    assert kt.loglik.dtype == torch.float64
    ll64 = float(tss.ss_filter_smoother(torch.as_tensor(Y), TP.from_numpy(p),
                                        tau=TAU)[0].loglik)
    for ll in (float(kt.loglik), float(kj.loglik)):
        assert abs(ll - ll64) < 1e-5 * abs(ll64)
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik), rtol=1e-5)
