"""The dense engine past its first kernel's range (N > 32 or k > 32, to N
= 128 and k = 128: K15-gen in ``csrc/gen_filters.cu``) against the JAX
package at float64 on the CPU, where the wrapper runs its plain twin.

- ``kalman_filter`` at (N, k) = (40, 10) and (64, 36), T = 40, masked (a
  fully missing step, a step observing fewer than k series) and not,
  agrees with ``dfm_tpu.ssm.kalman.kalman_filter`` (jitted: one compile a
  shape) to 1e-10 relative.
- A 3-iteration ``fit(filter="dense")`` at the same (N, k), from the
  generating params in both packages, agrees to 1e-9.
- The routes: ``kernels.route_dense`` gives K15's own kernel to N = 32 and
  k = 32 and the generic one past either, to 128; at N = 129 or k = 129
  the entry point raises ``NotImplementedError`` naming the ROADMAP row
  before any launch (a "meta" tensor takes the kernel route without a
  card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.backends.cpu_ref import SSMParams as NP
from dfm_tpu.ssm import kalman as jk
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.ssm import kalman as tk
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL, EM_RTOL = 1e-10, 1e-9
T = 40
CASES = ((40, 10), (64, 36))                 # (N, k)


def _panel(N, k, seed):
    """(params, Y with NaN at missing, mask): AR(1) factors with diagonal
    A, Q = I, the stationary P0; 15% scattered missing, step 0 fully
    missing, step 3 observing k - 1 series."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 0.8, k)
    p = NP(rng.standard_normal((N, k)), np.diag(a), np.eye(k),
           rng.uniform(0.5, 1.5, N), np.zeros(k),
           np.diag(1.0 / (1.0 - a * a)))
    Y, _ = dgp.simulate(p, T, rng)
    W = (rng.random((T, N)) > 0.15).astype(float)
    W[0] = 0.0
    W[3] = 0.0
    W[3, :k - 1] = 1.0
    return p, np.where(W > 0, Y, np.nan), W


_jax_filter = jax.jit(jk.kalman_filter)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("N,k", CASES)
def test_kalman_filter_matches_jax(N, k, masked):
    p, Y, W = _panel(N, k, seed=N + k)
    if not masked:
        Y = np.nan_to_num(Y)
    kj = _jax_filter(jnp.asarray(Y), JP.from_numpy(p, jnp.float64),
                     jnp.asarray(W) if masked else None)
    kt = tk.kalman_filter(torch.as_tensor(Y), TP.from_numpy(p),
                          mask=torch.as_tensor(W) if masked else None)
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik),
                               rtol=RTOL)
    for name in ("x_pred", "P_pred", "x_filt", "P_filt"):
        close(getattr(kt, name), getattr(kj, name), RTOL)


@pytest.mark.parametrize("N,k", CASES)
def test_dense_fit_matches_jax(N, k):
    """A 3-iteration chunked fit(filter="dense") from the generating
    params, both packages: logliks, params and factors at 1e-9."""
    p, Y, _ = _panel(N, k, seed=N + k)
    kw = dict(max_iters=3, tol=0.0, init=p)
    rj = jfit(JModel(k), Y, backend=TPUBackend(dtype=np.float64,
                                               filter="dense"),
              robust=False, **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(k), Y, backend=dtt.TorchBackend(
        device="cpu", dtype=torch.float64, filter="dense"), **kw)
    assert rt.filter == rj.filter == "dense"
    assert rt.n_iters == rj.n_iters == 3
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=EM_RTOL)
    for name in ("Lam", "A", "Q", "R", "mu0", "P0"):
        close(getattr(rt.params, name), getattr(rj.params, name), EM_RTOL)
    close(rt.factors, rj.factors, EM_RTOL)


def test_routes_at_the_tier_ends():
    for N, k in ((1, 1), (32, 32), (31, 10), (24, 2)):
        assert kernels.route_dense("dense_filter", N, k) == "dense_filter"
    for N, k in ((33, 10), (10, 33), (128, 128), (128, 1), (1, 128)):
        assert kernels.route_dense("dense_filter", N, k) == \
            "dense_filter_gen"
    assert kernels.KERNELS["dense_filter_gen"][0] == "gen_filters.cu"
    with pytest.raises(ValueError):
        kernels.route_dense("dense_filter", 0, 3)


@pytest.mark.parametrize("N,k", [(129, 10), (10, 129), (129, 129)])
def test_past_128_raises_before_any_launch(N, k):
    Y = torch.empty((5, N), dtype=torch.float32, device="meta")
    p = TP(*(torch.empty(s, dtype=torch.float32, device="meta")
             for s in ((N, k), (k, k), (k, k), (N,), (k,), (k, k))))
    kernels.reset_launches()
    with pytest.raises(NotImplementedError, match="Generic k"):
        tk.kalman_filter(Y, p)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
