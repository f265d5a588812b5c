"""The rank-r engine past its first kernels' range (k > 100 or r > 32, to
k = 128 and r = k: K9-basis-gen, K9-fwd-gen, K9-bwd-gen in
``csrc/gen_filters.cu``) against the JAX package at float64 on the CPU,
where each wrapper runs its plain twin.

- ``policy_basis`` (compared through its projector V V': the engine is
  invariant to V -> V B), ``lowrank_from_stats`` and ``lowrank_smoother``
  at (k, r) = (104, 8), (40, 36) and (36, 36) (r = k), T = 40, agree with
  the JAX functions (jitted: one compile a shape) to 1e-10 relative,
  masked (a fully missing step; every other step observes more than r
  series).
- A 3-iteration ``fit(filter="lowrank")`` at the same (k, r), from the
  generating params in both packages, agrees to 1e-9 (T = 40; at k = 104
  T = 106, since ``fit`` takes k <= min(T, N)).
- The routes: ``kernels.route_lowrank`` gives K9's own kernels to k = 100
  and r = 32 and the generic ones past either, to k = 128 and any r <= k;
  at k = 129 (whatever r) every entry point raises ``NotImplementedError``
  naming the ROADMAP row before any launch ("meta" tensors take the kernel
  route without a card), and r > k stays a ``ValueError``.
"""

import functools

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
from dfm_tpu.ssm import lowrank_filter as jl
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.ssm import lowrank_filter as tl
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, EM_RTOL = 1e-10, 1e-9
T = 40
CASES = ((104, 8), (40, 36), (36, 36))      # (k, r)
N_OF = {104: 120, 40: 60, 36: 56}
FULL_MISS = 7


def _params(N, k, rng):
    """AR(1) factors with diagonal A, Q = I, the stationary P0; loadings
    scaled down the columns so the information matrix's eigenvalues are
    apart at r.  (``dgp.dfm_params`` solves the k^2 x k^2 Lyapunov
    system, ~13 s at k = 104.)"""
    a = rng.uniform(0.3, 0.8, k)
    Lam = rng.standard_normal((N, k)) / (1.0 + np.arange(k))[None, :]
    return NP(Lam, np.diag(a), np.eye(k), rng.uniform(0.5, 1.5, N),
              np.zeros(k), np.diag(1.0 / (1.0 - a * a)))


def _panel(k, seed, T_=T):
    """(params, Y zero-filled at missing, mask): 10% scattered missing and
    step FULL_MISS unobserved."""
    rng = np.random.default_rng(seed)
    N = N_OF[k]
    p = _params(N, k, rng)
    Y, _ = dgp.simulate(p, T_, rng)
    W = (rng.random((T_, N)) > 0.1).astype(float)
    W[FULL_MISS] = 0.0
    return p, np.where(W > 0, Y, 0.0), W


@functools.partial(jax.jit, static_argnums=3)
def _jax_pair(Y, p, mask, r):
    kf = jl.lowrank_filter(Y, p, mask=mask, rank=r)
    return kf, jl.lowrank_smoother(kf, p, rank=r)


_jax_basis = jax.jit(jl.policy_basis, static_argnums=2)


@pytest.fixture(scope="module")
def passes():
    """Per (k, r): the JAX filter and smoother and the port's on the same
    masked panel."""
    out = {}
    for k, r in CASES:
        p, Y, W = _panel(k, seed=k + r)
        pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
        kj, sj = _jax_pair(jnp.asarray(Y), pj, jnp.asarray(W), r)
        kt, st = tl.lowrank_filter_smoother(torch.as_tensor(Y), pt,
                                            mask=torch.as_tensor(W), rank=r)
        out[k, r] = (p, (kj, sj), (kt, st))
    return out


@pytest.mark.parametrize("k,r", CASES)
def test_policy_basis_projector_matches_jax(k, r):
    p, _, _ = _panel(k, seed=k + r)
    Lam, R = np.asarray(p.Lam), np.asarray(p.R)
    Vj = np.asarray(_jax_basis(jnp.asarray(Lam), jnp.asarray(R), r))
    Vt = tl.policy_basis(torch.as_tensor(Lam), torch.as_tensor(R), r).numpy()
    assert Vt.shape == (k, r)
    np.testing.assert_allclose(Vt.T @ Vt, np.eye(r), atol=1e-12)
    close(Vt @ Vt.T, Vj @ Vj.T, PASS_RTOL)


@pytest.mark.parametrize("k,r", CASES)
def test_filter_and_smoother_match_jax(passes, k, r):
    """lowrank_from_stats (through lowrank_filter) and lowrank_smoother:
    every moment, the per-step loglik terms' sum and the lag-one
    covariances at 1e-10."""
    _, (kj, sj), (kt, st) = passes[k, r]
    for name in ("x_pred", "P_pred", "x_filt", "P_filt"):
        close(getattr(kt, name), getattr(kj, name), PASS_RTOL)
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik),
                               rtol=PASS_RTOL)
    for name in ("x_sm", "P_sm", "P_lag"):
        close(getattr(st, name), getattr(sj, name), PASS_RTOL)


@pytest.mark.parametrize("k,r", CASES)
def test_from_stats_takes_the_twin_and_launches_nothing(passes, k, r):
    """On the CPU the wrappers run the twins at any (k, r): the scan from
    the statistics equals the filter's moments bit for bit."""
    p, Y, W = _panel(k, seed=k + r)
    pt = TP.from_numpy(p)
    stats = tl.obs_stats(torch.as_tensor(Y), pt.Lam, pt.R,
                         mask=torch.as_tensor(W))
    kernels.reset_launches()
    out = tl.lowrank_from_stats(stats, pt, r)
    _, _, (kt, _) = passes[k, r]
    for got, want in zip(out[:4], kt[:4]):
        assert torch.equal(got, want)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize("k,r", CASES)
def test_fit_matches_jax(k, r):
    """A 3-iteration chunked fit(filter="lowrank") from the generating
    params, both packages: logliks, params and factors at 1e-9."""
    p, Y, W = _panel(k, seed=k + r, T_=max(T, k + 2))
    Y = np.where(W > 0, Y, np.nan)
    kw = dict(max_iters=3, tol=0.0, init=p)
    rj = jfit(JModel(k), Y, backend=TPUBackend(
        dtype=np.float64, filter="lowrank", rank=r, robust=False), **kw)
    rt = dtt.fit(dtt.DynamicFactorModel(k), Y, backend=dtt.TorchBackend(
        device="cpu", dtype=torch.float64, filter="lowrank", rank=r), **kw)
    assert rt.filter == rj.filter == "lowrank"
    assert rt.n_iters == rj.n_iters and rt.converged == rj.converged
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=EM_RTOL)
    for name in ("Lam", "A", "Q", "R", "mu0", "P0"):
        close(getattr(rt.params, name), getattr(rj.params, name), EM_RTOL)
    close(rt.factors, rj.factors, EM_RTOL)


@pytest.mark.parametrize("name", ["lowrank_basis", "lowrank_scan",
                                  "lowrank_smoother"])
def test_routes_at_the_tier_ends(name):
    for k, r in ((1, 1), (100, 32), (32, 32), (100, 1)):
        assert kernels.route_lowrank(name, k, r) == name
    for k, r in ((101, 8), (40, 33), (128, 128), (128, 1), (33, 33)):
        assert kernels.route_lowrank(name, k, r) == f"{name}_gen"
        assert kernels.KERNELS[f"{name}_gen"][0] == "gen_filters.cu"
    with pytest.raises(ValueError):
        kernels.route_lowrank(name, 40, 41)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _entry_calls(k, r, T_=5):
    return {
        "lowrank_basis": lambda: tl.lowrank_basis(_meta(1, k, k), r),
        "lowrank_scan": lambda: tl.lowrank_scan(
            _meta(1, T_, k), _meta(1, k, k), _meta(1, k, r), _meta(1, k, k),
            _meta(1, k, k), _meta(1, k), _meta(1, k, k)),
        "lowrank_smoother": lambda: tl.lowrank_smoother_scan(
            _meta(1, T_, k), _meta(1, T_, k, k), _meta(1, T_, k),
            _meta(1, T_, k, k), _meta(1, k, k), _meta(1, k, r)),
    }


@pytest.mark.parametrize("k,r", [(129, 8), (129, 129), (200, 40)])
@pytest.mark.parametrize("name", ["lowrank_basis", "lowrank_scan",
                                  "lowrank_smoother"])
def test_entry_points_raise_past_128_before_any_launch(name, k, r):
    kernels.reset_launches()
    with pytest.raises(NotImplementedError, match="Generic k"):
        _entry_calls(k, r)[name]()
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize("name", ["lowrank_basis", "lowrank_scan",
                                  "lowrank_smoother"])
def test_rank_above_k_is_a_value_error(name):
    with pytest.raises(ValueError):
        _entry_calls(40, 41)[name]()
