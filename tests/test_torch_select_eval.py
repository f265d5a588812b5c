"""The port's k-grid selection (dfm_tpu_torch.estim.select) and
rolling-window evaluation (dfm_tpu_torch.estim.evaluate) against the JAX
package's at float64 on the CPU.

Both run on the batched engine (``fit_many``); the JAX side at x64 with
an f64 ``TPUBackend(filter="info")`` where a lone fit runs, the port with
``TorchBackend(device="cpu", dtype=torch.float64, filter="info")``.
Logliks and criteria agree to 1e-9 relative, forecast errors to 1e-7
(EM paths: each pass's ~1e-15 rounding carried through the iterations
and the forecast).
"""

import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.estim.evaluate import oos_evaluate as joos
from dfm_tpu.estim.select import select_n_factors_em as jselect
from dfm_tpu.utils import dgp
from torch_parity import close, one_torch_thread  # noqa: F401

CPU64 = dtt.TorchBackend(device="cpu", dtype=torch.float64, filter="info")


@pytest.mark.parametrize("criterion", ["bic", "aic"])
def test_select_n_factors_em_matches_jax(criterion):
    rng = np.random.default_rng(6)
    p_true = dgp.dfm_params(16, 3, rng, noise_scale=0.3)
    Y, _ = dgp.simulate(p_true, 80, rng)
    kw = dict(ks=[1, 2, 3], max_iters=12, criterion=criterion)
    want = jselect(Y, dtype=np.float64, **kw)
    got = dtt.select_n_factors_em(Y, backend=CPU64, **kw)
    np.testing.assert_array_equal(got.ks, want.ks)
    np.testing.assert_allclose(got.logliks, want.logliks, rtol=1e-9)
    np.testing.assert_allclose(got.ic, want.ic, rtol=1e-9)
    assert got.k_best == want.k_best == 3
    np.testing.assert_array_equal(got.fit.n_iters, want.fit.n_iters)
    with pytest.raises(ValueError, match="criterion"):
        dtt.select_n_factors_em(Y, ks=[1], max_iters=1, criterion="hq",
                                backend=CPU64)


@pytest.fixture(scope="module")
def oos_panel():
    rng = np.random.default_rng(7)
    F = rng.standard_normal((70, 2))
    Lam = rng.standard_normal((14, 2))
    return F @ Lam.T + 0.4 * rng.standard_normal((70, 14))


@pytest.mark.parametrize("engine,warm", [("batched", True),
                                         ("batched", False),
                                         ("loop", True)])
def test_oos_evaluate_matches_jax(oos_panel, engine, warm):
    kw = dict(horizon=2, n_windows=4, min_train=50, max_iters=6,
              warm_start=warm, engine=engine)
    want = joos(JModel(2), oos_panel,
                backend=TPUBackend(dtype=np.float64, filter="info"), **kw)
    got = dtt.oos_evaluate(dtt.DynamicFactorModel(2), oos_panel,
                           backend=CPU64, **kw)
    np.testing.assert_array_equal(got.origins, want.origins)
    for name in ("errors", "rmse", "rmse_naive", "rmse_mean", "rel_rmse"):
        close(getattr(got, name), getattr(want, name), 1e-7)
    assert np.isfinite(got.rel_rmse).all() and got.rel_rmse.shape == (14,)


def test_batched_oos_rejects_expanding_windows(oos_panel):
    with pytest.raises(ValueError, match="rolling"):
        dtt.oos_evaluate(dtt.DynamicFactorModel(2), oos_panel, n_windows=3,
                         min_train=50, window="expanding", engine="batched",
                         backend=CPU64)
    with pytest.raises(ValueError, match="engine"):
        dtt.oos_evaluate(dtt.DynamicFactorModel(2), oos_panel,
                         engine="vmap", backend=CPU64)
