"""dfm_tpu_torch.fit against dfm_tpu.api.fit at float64 on the CPU.

Both packages run the same pipeline (standardize, NumPy PCA init, chunked
EM on the information form, reporting smooth, forecast) on the same
numpy-seeded panels, so everything a user reads off the result agrees to
1e-9 relative: the EM path carries ~1e-13 per-iteration rounding
differences into the next iteration's params (the single-pass checks in
test_torch_info_filter.py hold at 1e-10).  The device-init path
(standardize and Gram-eigh PCA as tensors) is compared up to the sign of
each factor, which two eigensolvers may choose differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.api import forecast as jforecast
from dfm_tpu.estim.init import pca_init_device as jpca_device
from dfm_tpu.utils import dgp
from dfm_tpu_torch.estim.init import pca_init_device as tpca_device
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-9


def _panel(N, T, k, seed, frac_missing=0.0):
    rng = np.random.default_rng(seed)
    p = dgp.dfm_params(N, k, rng)
    Y, _ = dgp.simulate(p, T, rng)
    Y = 3.0 * Y + 1.5                           # standardization matters
    if frac_missing:
        Y[rng.random(Y.shape) < frac_missing] = np.nan
        Y[T - 4:, : N // 3] = np.nan            # a ragged edge
    return Y


def _signs(Lam_t, Lam_j):
    return np.sign(np.sum(Lam_t * Lam_j, axis=0))


@pytest.mark.parametrize("N,masked,dynamics", [(40, False, "ar1"),
                                                (40, True, "ar1"),
                                                (36, True, "static"),
                                                (12, True, "ar1")])
def test_fit_matches_the_jax_package(N, masked, dynamics):
    Y = _panel(N, 90, 3, seed=N, frac_missing=0.15 if masked else 0.0)
    kw = dict(max_iters=30, tol=1e-6)
    rj = jfit(JModel(3, dynamics=dynamics), Y,
              backend=TPUBackend(dtype=np.float64), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(3, dynamics=dynamics), Y,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64),
                 **kw)
    assert rt.filter == rj.filter == ("dense" if N < 32 else "info")
    assert (rt.n_iters, rt.converged) == (rj.n_iters, rj.converged)
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=RTOL)
    for name in ("Lam", "A", "Q", "R", "mu0", "P0"):
        close(getattr(rt.params, name), getattr(rj.params, name), RTOL)
    close(rt.factors, rj.factors, RTOL)
    close(rt.factor_cov, rj.factor_cov, RTOL)
    close(rt.standardizer.scale, rj.standardizer.scale, RTOL)
    for got, want in zip(dtt.forecast(rt, 6), jforecast(rj, 6)):
        close(got, want, RTOL)
    assert [h["iter"] for h in rt.history] == list(range(rt.n_iters))
    assert [h["loglik"] for h in rt.history] == list(rt.logliks)


def test_pca_init_device_up_to_column_sign():
    Y = _panel(60, 120, 3, seed=5)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    pj = jpca_device(jnp.asarray(Y), 3, dtype=jnp.float64)
    pt = tpca_device(torch.as_tensor(Y), 3)
    s = _signs(pt.Lam, pj.Lam)
    D = np.diag(s)
    close(pt.Lam * s, pj.Lam, RTOL)
    close(pt.R, pj.R, RTOL)
    close(D @ pt.A @ D, pj.A, RTOL)
    close(D @ pt.Q @ D, pj.Q, RTOL)
    close(D @ pt.P0 @ D, pj.P0, RTOL)


def test_device_init_fit_up_to_column_sign():
    """device_init=True on both: prep_standardize + Gram-eigh PCA as
    tensors; the likelihood path is invariant to factor signs."""
    Y = _panel(48, 100, 2, seed=9)
    kw = dict(max_iters=12, tol=0.0)
    rj = jfit(JModel(2), Y, backend=TPUBackend(dtype=np.float64,
                                               device_init=True), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(2), Y,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64,
                                          device_init=True), **kw)
    assert rt.n_iters == rj.n_iters == 12
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=RTOL)
    s = _signs(rt.params.Lam, rj.params.Lam)
    close(rt.params.Lam * s, rj.params.Lam, RTOL)
    close(rt.factors * s, rj.factors, RTOL)
    close(rt.standardizer.mean, rj.standardizer.mean, RTOL)


def test_unported_engine_raises_instead_of_switching():
    """filter="pit" raised while the engine was unported; now it runs the
    covariance-form engine itself (no switch to another engine) and
    matches the JAX fit."""
    Y = _panel(40, 30, 2, seed=1)
    kw = dict(max_iters=4, tol=0.0)
    rj = jfit(JModel(2), Y, backend=TPUBackend(dtype=np.float64,
                                               filter="pit"), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(2), Y, **kw,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64,
                                          filter="pit"))
    assert rt.filter == rj.filter == "pit"
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=RTOL)
    s = _signs(rt.params.Lam, rj.params.Lam)
    close(rt.params.Lam * s, rj.params.Lam, RTOL)
    close(rt.factors * s, rj.factors, RTOL)


def test_unmasked_wide_panel_resolves_to_ss_and_matches():
    """N >= 512 unmasked: filter="auto" picks the steady-state engine
    with tau = auto_tau(init) on both; the JAX fit runs unguarded
    (robust=False), the port has no guard."""
    Y = _panel(512, 60, 2, seed=4)
    kw = dict(max_iters=6, tol=0.0)
    rj = jfit(JModel(2), Y, backend=TPUBackend(dtype=np.float64,
                                               robust=False), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(2), Y,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64),
                 **kw)
    assert rt.filter == rj.filter == "ss"
    assert 2 * rt.tau + 4 < Y.shape[0]          # the ss path itself ran
    assert rt.ss_delta is not None and rt.ss_delta >= 0.0
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=RTOL)
    for name in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, name), getattr(rj.params, name), RTOL)
    close(rt.factors, rj.factors, RTOL)
