"""The port's dense small-N engine (``filter="dense"``) against dfm_tpu at
float64 on the CPU.

- ``kalman_filter_plain``, kernel K15's plain twin, against
  ``dfm_tpu.ssm.kalman.kalman_filter``: the same Joseph-form step in the
  same association, so a single pass agrees to 1e-10 relative (the
  measured gap is ~1e-15), masked (a fully missing step 0, a step that
  observes fewer than k series) and not.
- ``fit`` with ``filter="auto"`` below N = 32 resolves to "dense" in both
  packages and agrees to 1e-9 (the EM path carries each pass's rounding
  into the next params), chunked and fused; so does a dense session.
- The wrapper's range: K15 takes N <= 32 and k <= 32 on the card, K15-gen
  to N = 128 and k = 128; a tensor off the CPU past that raises
  ``NotImplementedError`` naming the ROADMAP row before any launch (a
  "meta" tensor stands in for a CUDA one: it takes the kernel route, and
  the range check comes first).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu import open_session as jopen
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.ssm import kalman as jk
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.ssm import kalman as tk
from dfm_tpu_torch.ssm.params import SSMParams as TP
from dfm_tpu_torch.utils.data import Standardizer
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-10
EM_RTOL = 1e-9


def _panel(N, k, T, seed):
    rng = np.random.default_rng(seed)
    p = dgp.dfm_params(N, k, rng)
    Y, _ = dgp.simulate(p, T, rng)
    W = (rng.random((T, N)) > 0.15).astype(float)
    W[0] = 0.0                                    # step 0 fully missing
    W[3] = 0.0
    W[3, :k - 1] = 1.0                            # fewer than k observed
    return p, Y, W


@pytest.mark.parametrize("N,k,masked", [(12, 3, False), (12, 3, True),
                                        (31, 10, True), (24, 2, False)])
def test_kalman_filter_plain_matches_jax(N, k, masked):
    p, Y, W = _panel(N, k, 40, seed=N + k)
    if masked:
        Y = np.where(W > 0, Y, np.nan)            # NaN at the masked spots
    kj = jk.kalman_filter(jnp.asarray(Y), JP.from_numpy(p, jnp.float64),
                          mask=jnp.asarray(W) if masked else None)
    kt = tk.kalman_filter_plain(torch.as_tensor(Y), TP.from_numpy(p),
                                mask=torch.as_tensor(W) if masked else None)
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik),
                               rtol=RTOL)
    for name in ("x_pred", "P_pred", "x_filt", "P_filt"):
        close(getattr(kt, name), getattr(kj, name), RTOL)


def test_kalman_filter_takes_the_twin_on_cpu_and_launches_nothing():
    p, Y, W = _panel(12, 3, 30, seed=4)
    Yt, Wt, pt = torch.as_tensor(Y), torch.as_tensor(W), TP.from_numpy(p)
    kernels.reset_launches()
    got = tk.kalman_filter(Yt, pt, mask=Wt)
    want = tk.kalman_filter_plain(Yt, pt, mask=Wt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert kernels.KERNELS["dense_filter"][0] == "dense_filter.cu"


@pytest.mark.parametrize("N,k", [(129, 3), (3, 129), (140, 140)])
def test_past_the_kernel_range_raises_naming_the_roadmap_row(N, k):
    Y = torch.empty((5, N), dtype=torch.float32, device="meta")
    p = TP(*(torch.empty(s, dtype=torch.float32, device="meta")
             for s in ((N, k), (k, k), (k, k), (N,), (k,), (k, k))))
    with pytest.raises(NotImplementedError, match="Generic k"):
        tk.kalman_filter(Y, p)


def test_kernel_range_ends_at_32():
    """K15's own kernel ends at N = k = 32; K15-gen takes the range on to
    128, where the check ends."""
    kernels.check_dense("dense_filter", 128, 128)
    kernels.check_dense("dense_filter", 1, 1)
    assert kernels.route_dense("dense_filter", 32, 32) == "dense_filter"
    assert kernels.route_dense("dense_filter", 33, 32) == "dense_filter_gen"
    with pytest.raises(ValueError):
        kernels.check_dense("dense_filter", 0, 3)
    with pytest.raises(NotImplementedError):
        kernels.check_dense("dense_filter", 129, 1)


@pytest.mark.parametrize("fused", [False, True])
def test_fit_auto_below_32_is_dense_and_matches_jax(fused):
    p, Y, W = _panel(20, 2, 60, seed=11)
    Y = np.where(W > 0, 2.0 * Y + 1.0, np.nan)
    kw = dict(max_iters=6, tol=0.0, fused=fused)
    rj = jfit(JModel(2), Y, backend=TPUBackend(dtype=np.float64),
              robust=False, **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(2), Y,
                 backend=dtt.TorchBackend(device="cpu", dtype=torch.float64),
                 **kw)
    assert rt.filter == rj.filter == "dense"
    assert rt.n_iters == rj.n_iters == 6
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=EM_RTOL)
    for name in ("Lam", "A", "Q", "R"):
        close(getattr(rt.params, name), getattr(rj.params, name), EM_RTOL)
    close(rt.factors, rj.factors, EM_RTOL)
    close(rt.factor_cov, rj.factor_cov, EM_RTOL)


def test_dense_session_matches_jax():
    """A dense session (N = 12 < 32) opened on the JAX fused fit's params,
    three updates and a re-forecast, against the JAX session."""
    p, Y, W = _panel(12, 2, 50, seed=21)
    Y = np.where(W > 0, Y, np.nan)
    jb = TPUBackend(dtype=np.float64, fused_chunk=4)
    rj = jfit(JModel(2), Y[:40], backend=jb, fused=True, max_iters=6,
              tol=0.0, robust=False)
    s = rj.standardizer
    rt = dtt.FitResult(
        params=rj.params, logliks=rj.logliks, factors=rj.factors,
        factor_cov=rj.factor_cov, converged=rj.converged, n_iters=rj.n_iters,
        standardizer=Standardizer(s.mean, s.scale),
        model=dtt.DynamicFactorModel(2), backend="torch", history=[],
        filter=rj.filter)
    kw = dict(capacity=48, max_update_rows=3, max_iters=4, tol=0.0)
    js = jopen(rj, Y[:40], backend=jb, robust=False, **kw)
    ts = dtt.open_session(rt, Y[:40], backend=dtt.TorchBackend(
        device="cpu", dtype=torch.float64, fused_chunk=4), **kw)
    assert ts.filter == js.filter == "dense"
    for sl in ((40, 43), (43, 44), None, (44, 47)):
        rows = None if sl is None else Y[sl[0]:sl[1]]
        tu, ju = ts.update(rows), js.update(rows)
        assert (tu.t, tu.n_iters) == (ju.t, ju.n_iters)
        for name in ("nowcast", "nowcast_sd", "factors", "factor_cov",
                     "logliks"):
            close(getattr(tu, name), getattr(ju, name), EM_RTOL)
        for key in ("y", "f"):
            close(tu.forecasts[key], ju.forecasts[key], EM_RTOL)
