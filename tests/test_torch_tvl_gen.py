"""The time-varying-loadings family past k = 16 (dfm_tpu_torch.models.
tv_loadings) against ``dfm_tpu.models.tv_loadings`` at float64 on the CPU,
where K2-tv, K1-tv, K11-fwd and K11-bwd run their plain twins, and the
kernel routes of the four entry points past 16.

On the card the four wrappers take their wide (K2-tv, K1-tv) or generic
kernels from k = 17 to 128 and raise at 129; here the twins run at any k,
so these tests hold the arithmetic at k = 20 and 40 (past the JAX
package's UNROLL_K_MAX = 8, where its smoother factors with
jnp.linalg.cholesky) and the routes by name.  Single passes agree to
1e-10 relative (``close``: to the array's largest entry), rounds and fits
to 1e-9.  The masked panels carry a ragged edge, scattered missing values,
a fully missing step and a never-observed series.  Each JAX result is
computed once per module.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.models import tv_loadings as jt
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.models import tv_loadings as tt
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
T, N = 40, 30
KS = (20, 40)
FULL_MISS, NEVER = 11, 4        # a fully missing step; a never-observed series
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)
NAMES = ("tvl_obs_stats", "tvl_quad", "loading_filter", "loading_smoother")


def _mask(seed=9):
    W = (np.random.default_rng(seed).random((T, N)) > 0.1).astype(float)
    W[T - 5:, :N // 3] = 0.0            # ragged edge
    W[FULL_MISS] = 0.0
    W[:, NEVER] = 0.0
    return W


@functools.lru_cache(maxsize=None)
def _panel(k):
    """(Y, F, Lams, A, R) of the random-walk DGP (walk scale 0.05, S4's)."""
    rng = np.random.default_rng(100 + k)
    return dgp.simulate_tv_loadings(N, T, k, rng, walk_scale=0.05)


@functools.lru_cache(maxsize=None)
def _inputs(k, masked):
    """(Y zero-filled at missing, mask or None, true F, true Lams, JAX
    params, port params): params at the truth, tau2 = 1e-3, Q = I."""
    Y, F, Lams, A, R = _panel(k)
    W = _mask() if masked else None
    Yz = Y if W is None else np.where(W > 0, Y, 0.0)
    pj = jt.TVLParams(Lam0=jnp.asarray(Lams[0]), tau2=jnp.full((N,), 1e-3),
                      A=jnp.asarray(A), Q=jnp.eye(k), R=jnp.asarray(R),
                      mu0=jnp.zeros(k), P0=jnp.eye(k))
    return Yz, W, F, Lams, pj, tt.TVLParams.from_numpy(pj)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


CASES = [(k, m) for k in KS for m in (False, True)]
PASSES = pytest.mark.parametrize(
    "k,masked", CASES,
    ids=[f"k{k}-{'masked' if m else 'unmasked'}" for k, m in CASES])
MASKED = pytest.mark.parametrize("masked", [False, True],
                                 ids=["unmasked", "masked"])


@functools.lru_cache(maxsize=None)
def _jax_factor_pass(k, masked):
    Yz, W, _, Lams, pj, _ = _inputs(k, masked)
    return jt.factor_pass_tv(jnp.asarray(Yz), jnp.asarray(Lams), pj,
                             mask=_j(W))


@functools.lru_cache(maxsize=None)
def _jax_loading_pass(k, masked):
    Yz, W, F, _, pj, _ = _inputs(k, masked)
    return jt.loading_pass(jnp.asarray(Yz), jnp.asarray(F), pj, mask=_j(W))


# ------------------------------------------------------------- passes ---

@PASSES
def test_obs_stats_tv_past_16_matches_jax(k, masked):
    Yz, W, _, Lams, pj, pt = _inputs(k, masked)
    sj = jt.obs_stats_tv(jnp.asarray(Yz), jnp.asarray(Lams), pj.R, mask=_j(W))
    st = tt.obs_stats_tv(_t(Yz), _t(Lams), pt.R, _t(W))
    assert st.C.shape == (T, k, k)
    for got, want in zip(st, sj):
        close(got.numpy(), want, PASS_RTOL)
    if masked:
        assert float(st.n[FULL_MISS]) == 0.0
        np.testing.assert_array_equal(st.C[FULL_MISS].numpy(), 0.0)


@PASSES
def test_factor_pass_tv_past_16_matches_jax(k, masked):
    """K2-tv, the K4 pair and K1-tv (the residual pass the loglik reads)."""
    Yz, W, _, Lams, _, pt = _inputs(k, masked)
    kj, sj = _jax_factor_pass(k, masked)
    kt, st = tt.factor_pass_tv(_t(Yz), _t(Lams), pt, _t(W))
    close(float(kt.loglik), float(kj.loglik), PASS_RTOL)
    for name in ("x_pred", "P_filt"):
        close(getattr(kt, name).numpy(), getattr(kj, name), PASS_RTOL)
    for name in ("x_sm", "P_sm", "P_lag"):
        close(getattr(st, name).numpy(), getattr(sj, name), PASS_RTOL)


@PASSES
def test_quad_local_tv_past_16_matches_the_jax_residual_pass(k, masked):
    """K1-tv's twin at the JAX filter's x_pred: quad_R and U =
    sum (v / R) lam_t,n as ``factor_pass_tv`` forms them (lines 111-117)."""
    Yz, W, _, Lams, pj, pt = _inputs(k, masked)
    xp = np.array(_jax_factor_pass(k, masked)[0].x_pred)
    V = Yz - np.einsum("tnk,tk->tn", Lams, xp)
    if W is not None:
        V = W * V
    R = np.asarray(pj.R)
    quad, U = tt.quad_local_tv(_t(Yz), _t(Lams), pt.R, _t(xp), _t(W))
    assert quad.dtype == torch.float64 and U.shape == (T, k)
    close(quad.numpy(), (V * V / R).sum(1), PASS_RTOL)
    close(U.numpy(), np.einsum("tn,tnk->tk", V / R, Lams), PASS_RTOL)


@PASSES
def test_loading_pass_past_16_matches_jax(k, masked):
    """lam_sm, P_sm and incr: the JAX smoother's batched Cholesky branch
    (k > UNROLL_K_MAX), and the two halves compose to the pass."""
    Yz, W, F, _, _, pt = _inputs(k, masked)
    got = tt.loading_pass(_t(Yz), _t(F), pt, _t(W))
    for g, w in zip(got, _jax_loading_pass(k, masked)):
        close(g.numpy(), w, PASS_RTOL)
    lam_f, P_f = tt.loading_filter(_t(Yz), _t(F), pt.Lam0, pt.tau2, pt.R,
                                   _t(W))
    assert lam_f.shape == (T, N, k) and P_f.shape == (T, N, k, k)
    # The filtered covariances are exactly symmetric (the kernels' rows
    # rely on it).
    np.testing.assert_array_equal(P_f.numpy(),
                                  P_f.transpose(-1, -2).numpy())
    for g, w in zip(tt.loading_smoother(lam_f, P_f, pt.tau2), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    if masked:
        np.testing.assert_array_equal(lam_f[:, NEVER].numpy(),
                                      np.broadcast_to(pt.Lam0[NEVER].numpy(),
                                                      (T, k)))


# ------------------------------------------------------- rounds, fits ---

SPEC20 = dict(n_factors=20, n_rounds=3)


@MASKED
def test_tvl_round_core_k20_matches_jax(masked):
    Yz, W, _, Lams, pj, pt = _inputs(20, masked)
    spec_j, spec_t = jt.TVLSpec(**SPEC20), tt.TVLSpec(**SPEC20)
    Lj, qj, llj, Fj = jt.tvl_round_core(jnp.asarray(Yz), _j(W),
                                        jnp.asarray(Lams), pj, spec_j)
    Lt, qt, llt, Ft = tt.tvl_round_core(_t(Yz), _t(W), _t(Lams), pt, spec_t)
    close(Lt.numpy(), Lj, FIT_RTOL)
    close(Ft.numpy(), Fj, FIT_RTOL)
    close(float(llt), float(llj), FIT_RTOL)
    for name in tt.TVLParams._fields:
        close(getattr(qt, name).numpy(), getattr(qj, name), FIT_RTOL)


@MASKED
def test_fit_tvl_k20_matches_jax(masked):
    """``fit(TVLSpec(n_factors=20, n_rounds=3))`` on the CPU backend
    against the JAX package's ``tvl_fit`` (default chunks of 8)."""
    Y = _panel(20)[0]
    if masked:
        Y = np.where(_mask() > 0, Y, np.nan)
    rt = dtt.fit(dtt.TVLSpec(**SPEC20), Y, backend=CPU)
    rj = jt.tvl_fit(Y, jt.TVLSpec(**SPEC20))
    assert isinstance(rt, tt.TVLResult)
    assert len(rt.logliks) == len(rj.logliks) == 3
    assert rt.converged == rj.converged
    close(rt.logliks, rj.logliks, FIT_RTOL)
    for name in ("loadings", "factors", "common"):
        close(getattr(rt, name), getattr(rj, name), FIT_RTOL)
    for name in tt.TVLParams._fields:
        close(getattr(rt.params, name), np.asarray(getattr(rj.params, name)),
              FIT_RTOL)
    yt, ft = dtt.forecast(rt, 4)
    yj, fj = jt.tvl_forecast(rj, 4)
    close(yt, yj, FIT_RTOL)
    close(ft, fj, FIT_RTOL)


# ------------------------------------------------------------- routes ---

ROUTES = {16: {n: n for n in NAMES},
          17: {"tvl_obs_stats": "tvl_obs_stats_wide",
               "tvl_quad": "tvl_quad_wide",
               "loading_filter": "loading_filter_gen",
               "loading_smoother": "loading_smoother_gen"},
          32: {"tvl_obs_stats": "tvl_obs_stats_wide",
               "tvl_quad": "tvl_quad_wide",
               "loading_filter": "loading_filter_gen",
               "loading_smoother": "loading_smoother_gen"},
          33: {n: f"{n}_gen" for n in NAMES},
          128: {n: f"{n}_gen" for n in NAMES}}


@pytest.mark.parametrize("k", sorted(ROUTES))
@pytest.mark.parametrize("name", NAMES)
def test_tvl_routes(name, k):
    """Today's kernel to 16; K2-tv and K1-tv's wide kernels to 32, K11's
    generic kernels from 17; every routed kernel in the entry point's
    source, but K11's generic pair, which has a source of its own
    (``tv_loadings_gen.cu``: the k <= 16 kernels build apart, first)."""
    got = kernels.route(name, k)
    assert got == ROUTES[k][name]
    assert got in kernels.KERNELS and got in kernels.LAUNCHES
    assert kernels.KERNELS[got][0] == (
        "tv_loadings_gen.cu" if got.startswith("loading_")
        and got.endswith("_gen") else kernels.KERNELS[name][0])


def _meta(*shape):
    """A tensor with no storage: a wrapper takes its kernel route for any
    device but the CPU, so a "meta" tensor reaches the range check without
    a card."""
    return torch.zeros(shape, device="meta")


def test_tvl_past_128_raises_before_any_launch():
    k = kernels.GEN_KMAX + 1
    for name in NAMES:
        with pytest.raises(NotImplementedError, match="Generic k") as err:
            kernels.route(name, k)
        assert kernels.GENERIC_K in str(err.value)
    kernels.reset_launches()
    Y, L, v = _meta(4, 6), _meta(4, 6, k), _meta(6)
    F, P = _meta(4, k), _meta(4, 6, k, k)
    pt = tt.TVLParams(L[0], v, _meta(k, k), _meta(k, k), v, _meta(k),
                      _meta(k, k))
    calls = [lambda: tt.obs_stats_tv(Y, L, v),
             lambda: tt.quad_local_tv(Y, L, v, F),
             lambda: tt.loading_filter(Y, F, L[0], v, v),
             lambda: tt.loading_smoother(L, P, v),
             lambda: tt.factor_pass_tv(Y, L, pt),
             lambda: tt.loading_pass(Y, F, pt),
             lambda: tt.tvl_round_core(Y, None, L, pt,
                                       tt.TVLSpec(n_factors=k))]
    for call in calls:
        with pytest.raises(NotImplementedError, match="Generic k"):
            call()
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(kernels.QUERIES))
def test_sizing_rules_are_exported_by_their_source(name):
    """Each host-side sizing rule (``kernels.QUERIES``, such as K11-bwd-gen's
    workspace slots) is an entry of its source with the argument count its
    row declares, so the rule lives in the .cu file alone."""
    source, argtypes = kernels.QUERIES[name]
    text = (kernels.CSRC / source).read_text()
    m = re.search(rf"int {name}_##SFX\(([^)]*)\)", text)
    assert m is not None
    assert len(m.group(1).split(",")) == len(argtypes)
