"""The lone fits at 16 < k <= 32, where the card takes the wide kernels of
K3 (``mstep_rows_wide``), K5a (``ss_cov_path_wide``) and K5b
(``affine_scan_wide``), against dfm_tpu at float64 on the CPU.

The CPU runs each kernel's plain twin, which takes any k, so these tests
hold the paths' algebra at k = 20 against the JAX package (the EM paths at
1e-9 relative: each iteration carries ~1e-13 rounding into the next
params), and ``kernels.route`` to the wide kernel's range: today's kernel
for k <= 16, the wide one (same source file) for 17..32, the generic one
from 33 to 128 and ``NotImplementedError`` naming the ROADMAP row at 129.
"""

import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-9
K = 20
NEW_WIDE = ("mstep_rows", "ss_cov_path", "affine_scan")


@pytest.fixture(scope="module")
def panels():
    """(120, 60) panel at k = 20: fully observed, and with scattered
    missing values, a ragged edge and a step observing fewer than k
    series."""
    rng = np.random.default_rng(2020)
    p = dgp.dfm_params(60, K, rng)
    Y, _ = dgp.simulate(p, 120, rng)
    Y = 1.5 * Y + 0.5
    Ym = Y.copy()
    Ym[rng.random(Y.shape) < 0.1] = np.nan
    Ym[114:, :20] = np.nan
    Ym[7] = np.nan
    Ym[7, :K - 3] = Y[7, :K - 3]
    return Y, Ym


@pytest.mark.parametrize("flt,masked,engine", [("auto", True, "info"),
                                               ("pit", True, "pit"),
                                               ("ss", False, "ss")])
def test_wide_k_fit_matches_jax(panels, flt, masked, engine):
    Y = panels[1] if masked else panels[0]
    kw = dict(max_iters=4, tol=0.0)
    rj = jfit(JModel(K), Y, backend=TPUBackend(dtype=np.float64,
                                               filter=flt), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(K), Y,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64,
                                          filter=flt), **kw)
    assert rt.filter == rj.filter == engine
    if engine == "ss":
        assert 2 * rt.tau + 4 < Y.shape[0]         # not the exact fallback
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=RTOL)
    for name in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, name), getattr(rj.params, name), RTOL)
    close(rt.factors, rj.factors, RTOL)
    close(rt.factor_cov, rj.factor_cov, RTOL)


@pytest.mark.parametrize("k", [1, 16, 17, 25, 32])
def test_wide_routes_of_k3_k5a_k5b(k):
    for name in NEW_WIDE:
        got = kernels.route(name, k)
        assert got == (name if k <= kernels.KMAX else kernels.WIDE[name])
        assert kernels.KERNELS[got][0] == kernels.KERNELS[name][0]
        assert kernels.KERNELS[got][1] == kernels.KERNELS[name][1]


@pytest.mark.parametrize("name", NEW_WIDE)
def test_wide_routes_raise_at_33_naming_the_roadmap_row(name):
    """K3, K5a and K5b take their generic kernels from 33 to 128 and
    stop at 129."""
    assert kernels.route(name, 33) == kernels.GEN[name]
    with pytest.raises(NotImplementedError, match="Generic k"):
        kernels.route(name, 129)
    with pytest.raises(ValueError):
        kernels.route(name, 0)
    # check_k keeps its default range, KMAX: the batched twins reach their
    # wide kernels through route (tests/test_torch_batched_wide.py).
    with pytest.raises(NotImplementedError, match="Generic k"):
        kernels.check_k("batched_mstep_rows", 17)
