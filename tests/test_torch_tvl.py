"""The port's time-varying-loadings family (dfm_tpu_torch.models.tv_loadings
and its route through ``fit``) against ``dfm_tpu.models.tv_loadings`` at
float64 on the CPU, where every kernel (K2-tv, K1-tv, K11-fwd, K11-bwd and
the K4 pair) runs its plain twin.

Single passes agree to 1e-10 relative (``close``: to the array's largest
entry), fits to 1e-9, the tolerances of the other test_torch_* files.
The masked panels carry a ragged edge, scattered missing values, a fully
missing step and a never-observed series.  The JAX parameters cross by
``TVLParams.from_numpy``; each JAX fit is computed once per module and
shares one compiled round program per (spec, chunk length).
"""

import dataclasses
import functools

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
T, N, K = 50, 30, 2
FULL_MISS, NEVER = 17, 4        # a fully missing step; a never-observed series
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)
SPEC = dict(n_factors=K, n_rounds=6)
# tol = 1e-3 stops this panel's unmasked fit at its 5th loglik (relative
# steps 2.2e-2, 2.7e-3, 1.3e-3, 8.2e-4): inside the second chunk of 3.
STOP_TOL = 1e-3


def _mask(T_, N_, seed=9):
    W = (np.random.default_rng(seed).random((T_, N_)) > 0.1).astype(float)
    W[T_ - 5:, :N_ // 3] = 0.0          # ragged edge
    W[FULL_MISS] = 0.0
    W[:, NEVER] = 0.0
    return W


@functools.lru_cache(maxsize=None)
def _panel(T_=T, N_=N, k=K, seed=4):
    """(Y, F, Lams, A, R) of the random-walk DGP (walk scale 0.05, S4's)."""
    rng = np.random.default_rng(seed)
    return dgp.simulate_tv_loadings(N_, T_, k, rng, walk_scale=0.05)


def _inputs(masked, T_=T, N_=N, k=K, seed=4):
    """(Y zero-filled at missing, mask or None, true F, true Lams, JAX
    params, port params): params at the truth, tau2 = 1e-3, Q = I."""
    Y, F, Lams, A, R = _panel(T_, N_, k, seed)
    W = _mask(T_, N_) if masked else None
    Yz = Y if W is None else np.where(W > 0, Y, 0.0)
    pj = jt.TVLParams(Lam0=jnp.asarray(Lams[0]), tau2=jnp.full((N_,), 1e-3),
                      A=jnp.asarray(A), Q=jnp.eye(k), R=jnp.asarray(R),
                      mu0=jnp.zeros(k), P0=jnp.eye(k))
    return Yz, W, F, Lams, pj, tt.TVLParams.from_numpy(pj)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


MASKED = pytest.mark.parametrize("masked", [False, True],
                                 ids=["unmasked", "masked"])


# ------------------------------------------------------------- passes ---

@MASKED
def test_obs_stats_tv_matches_jax(masked):
    Yz, W, _, Lams, pj, pt = _inputs(masked)
    sj = jt.obs_stats_tv(jnp.asarray(Yz), jnp.asarray(Lams), pj.R, mask=_j(W))
    st = tt.obs_stats_tv(_t(Yz), _t(Lams), pt.R, _t(W))
    assert st.n.dtype == st.ldR.dtype == torch.float64
    for got, want in zip(st, sj):
        close(got.numpy(), want, PASS_RTOL)
    if masked:
        assert float(st.n[FULL_MISS]) == 0.0
        np.testing.assert_array_equal(st.C[FULL_MISS].numpy(), 0.0)


@MASKED
def test_quad_local_tv_matches_oracle(masked):
    """K1-tv's twin: the quadratic and U = sum (v / R) lam_t,n from the
    residual, against NumPy at x_pred = the true factors."""
    Yz, W, F, Lams, _, pt = _inputs(masked)
    R = pt.R.numpy()
    V = Yz - np.einsum("tnk,tk->tn", Lams, F)
    if W is not None:
        V = W * V
    quad, U = tt.quad_local_tv(_t(Yz), _t(Lams), pt.R, _t(F), _t(W))
    assert quad.dtype == torch.float64
    close(quad.numpy(), (V * V / R).sum(1), PASS_RTOL)
    close(U.numpy(), np.einsum("tn,tnk->tk", V / R, Lams), PASS_RTOL)


@MASKED
def test_factor_pass_tv_matches_jax(masked):
    Yz, W, _, Lams, pj, pt = _inputs(masked)
    kj, sj = jt.factor_pass_tv(jnp.asarray(Yz), jnp.asarray(Lams), pj,
                               mask=_j(W))
    kt, st = tt.factor_pass_tv(_t(Yz), _t(Lams), pt, _t(W))
    close(float(kt.loglik), float(kj.loglik), PASS_RTOL)
    for name in ("x_sm", "P_sm", "P_lag"):
        close(getattr(st, name).numpy(), getattr(sj, name), PASS_RTOL)


LOADING_CASES = [(2, False, "jax"), (2, True, "jax"), (3, False, "jax"),
                 (3, True, "jax"), (9, False, "jax"), (9, True, "jax"),
                 (9, True, "unrolled")]


@pytest.mark.parametrize("k,masked,route", LOADING_CASES,
                         ids=[f"k{k}-{'masked' if m else 'unmasked'}-{r}"
                              for k, m, r in LOADING_CASES])
def test_loading_pass_matches_jax(k, masked, route, monkeypatch):
    """lam_sm, P_sm and incr at k = 2, 3 and 9 (k = 9 crosses the JAX
    package's UNROLL_K_MAX: there it factors with jnp.linalg.cholesky).
    ``unrolled`` runs the plain twin's J' solve through the unrolled
    Cholesky at k = 9, the one routine the K11-bwd kernel uses at every k,
    against the JAX package's batched branch."""
    T_, N_ = (30, 20) if k == 9 else (T, N)
    Yz, W, F, _, pj, pt = _inputs(masked, T_, N_, k, seed=4 + k)
    if route == "unrolled":
        monkeypatch.setattr(tt, "UNROLL_K_MAX", 16)
    got = tt.loading_pass(_t(Yz), _t(F), pt, _t(W))
    want = jt.loading_pass(jnp.asarray(Yz), jnp.asarray(F), pj, mask=_j(W))
    for g, w in zip(got, want):
        close(g.numpy(), w, PASS_RTOL)
    # The two halves compose to the pass (the kernels' split).
    lam_f, P_f = tt.loading_filter(_t(Yz), _t(F), pt.Lam0, pt.tau2, pt.R,
                                   _t(W))
    assert lam_f.shape == (T_, N_, k) and P_f.shape == (T_, N_, k, k)
    for g, w in zip(tt.loading_smoother(lam_f, P_f, pt.tau2), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_loading_pass_unobserved_chain_walks_freely():
    """A never-observed series keeps its initial loading and its variance
    grows by tau2 a step; a fully missing step changes no chain."""
    Yz, W, F, _, _, pt = _inputs(True)
    lam_f, P_f = tt.loading_filter(_t(Yz), _t(F), pt.Lam0, pt.tau2, pt.R,
                                   _t(W))
    t2 = float(pt.tau2[NEVER])
    np.testing.assert_array_equal(lam_f[:, NEVER].numpy(),
                                  np.broadcast_to(pt.Lam0[NEVER].numpy(),
                                                  (T, K)))
    close(P_f[-1, NEVER].numpy(), (1e-2 + (T + 1) * t2) * np.eye(K),
          PASS_RTOL)
    np.testing.assert_array_equal(lam_f[FULL_MISS].numpy(),
                                  lam_f[FULL_MISS - 1].numpy())


@MASKED
def test_tvl_round_core_matches_jax(masked):
    Yz, W, _, Lams, pj, pt = _inputs(masked)
    spec_j, spec_t = jt.TVLSpec(**SPEC), tt.TVLSpec(**SPEC)
    Lj, qj, llj, Fj = jt.tvl_round_core(jnp.asarray(Yz), _j(W),
                                        jnp.asarray(Lams), pj, spec_j)
    Lt, qt, llt, Ft = tt.tvl_round_core(_t(Yz), _t(W), _t(Lams), pt, spec_t)
    close(Lt.numpy(), Lj, PASS_RTOL)
    close(Ft.numpy(), Fj, PASS_RTOL)
    close(float(llt), float(llj), PASS_RTOL)
    for name in tt.TVLParams._fields:
        close(getattr(qt, name).numpy(), getattr(qj, name), PASS_RTOL)


@MASKED
def test_tvl_round_scan_is_rounds_of_the_core(masked):
    Yz, W, _, Lams, _, pt = _inputs(masked)
    spec = tt.TVLSpec(**SPEC)
    (L2, p2), lls = tt.tvl_round_scan(_t(Yz), _t(W), _t(Lams), pt, spec,
                                      True, 2)
    L1, p1, ll0, _ = tt.tvl_round_core(_t(Yz), _t(W), _t(Lams), pt, spec)
    L1b, p1b, ll1, _ = tt.tvl_round_core(_t(Yz), _t(W), L1, p1, spec)
    assert lls.dtype == torch.float64 and lls.shape == (2,)
    np.testing.assert_array_equal(lls.numpy(), [float(ll0), float(ll1)])
    np.testing.assert_array_equal(L2.numpy(), L1b.numpy())


@MASKED
def test_tvl_loglik_eval_matches_jax(masked):
    Yz, W, _, Lams, pj, pt = _inputs(masked)
    want = jt.tvl_loglik_eval(Yz, Lams, pj, mask=W)
    close(tt.tvl_loglik_eval(Yz, Lams, pt, mask=W, device="cpu"), want,
          PASS_RTOL)
    close(tt.tvl_loglik_eval(_t(Yz), _t(Lams), pt.to_numpy(), mask=W), want,
          PASS_RTOL)


# --------------------------------------------------------------- fits ---

@functools.lru_cache(maxsize=None)
def _jax_fit(masked, fused_chunk, tol):
    Y = _panel()[0]
    if masked:
        Y = np.where(_mask(T, N) > 0, Y, np.nan)
    return jt.tvl_fit(Y, jt.TVLSpec(**SPEC, tol=tol), fused_chunk=fused_chunk)


def _port_fit(masked, fused_chunk, tol):
    Y = _panel()[0]
    if masked:
        Y = np.where(_mask(T, N) > 0, Y, np.nan)
    return tt.tvl_fit(Y, tt.TVLSpec(**SPEC, tol=tol), fused_chunk=fused_chunk,
                      device="cpu")


def _same_fit(rt, rj):
    assert len(rt.logliks) == len(rj.logliks)
    assert rt.converged == rj.converged
    close(rt.logliks, rj.logliks, FIT_RTOL)
    for name in ("loadings", "factors", "common"):
        close(getattr(rt, name), getattr(rj, name), FIT_RTOL)
    for name in tt.TVLParams._fields:
        close(getattr(rt.params, name), np.asarray(getattr(rj.params, name)),
              FIT_RTOL)


FIT_CASES = [(1, 0.0), (3, 0.0), (1, STOP_TOL), (3, STOP_TOL)]


@pytest.mark.parametrize("fused_chunk,tol", FIT_CASES,
                         ids=[f"chunk{c}-tol{t:g}" for c, t in FIT_CASES])
def test_tvl_fit_matches_jax(fused_chunk, tol):
    rt = _port_fit(False, fused_chunk, tol)
    rj = _jax_fit(False, fused_chunk, tol)
    _same_fit(rt, rj)
    if tol > 0:
        # Converged at its 5th loglik, inside the second chunk of 3.
        assert rt.converged and len(rt.logliks) == 5
    else:
        assert len(rt.logliks) == SPEC["n_rounds"] and not rt.converged
    assert rt.health.monotonicity_violations == 0 and rt.health.ok


def test_masked_tvl_fit_matches_jax():
    rt = _port_fit(True, 3, 0.0)
    _same_fit(rt, _jax_fit(True, 3, 0.0))
    assert len(rt.logliks) == SPEC["n_rounds"]
    assert np.isfinite(rt.loadings).all() and np.isfinite(rt.factors).all()


def test_tvl_fit_returns_the_state_the_stop_rule_chose():
    """A tol stop inside a chunk returns the state after exactly the
    update count the rule chose: refitting that many rounds from the same
    start at tol = 0 gives the same state."""
    stop = _port_fit(False, 3, STOP_TOL)
    Y = _panel()[0]
    ref = tt.tvl_fit(Y, tt.TVLSpec(**dict(SPEC, n_rounds=5), tol=0.0),
                     fused_chunk=5, device="cpu")
    np.testing.assert_array_equal(stop.loadings, ref.loadings)
    np.testing.assert_array_equal(stop.logliks, ref.logliks)


def test_tvl_forecast_matches_jax():
    rt, rj = _port_fit(True, 3, 0.0), _jax_fit(True, 3, 0.0)
    yt, ft = tt.tvl_forecast(rt, 12)
    yj, fj = jt.tvl_forecast(rj, 12)
    assert yt.shape == (12, N) and ft.shape == (12, K)
    close(yt, yj, FIT_RTOL)
    close(ft, fj, FIT_RTOL)
    y2, f2 = dtt.forecast(rt, 12)
    np.testing.assert_array_equal(y2, yt)
    np.testing.assert_array_equal(f2, ft)


def test_api_fit_routes_tvl_spec_like_jax():
    """``fit(TVLSpec)`` keeps the spec's n_rounds and tol unless
    max_iters / tol are given (tests/test_family_dispatch.py:40-57), on
    the backend's dtype, device and fused_chunk."""
    Y = _panel()[0]
    b3 = dtt.TorchBackend(device="cpu", dtype=torch.float64, fused_chunk=3)
    spec = tt.TVLSpec(**SPEC, tol=0.0)
    r_api = dtt.fit(spec, Y, backend=b3)           # the spec's 6 rounds
    assert isinstance(r_api, tt.TVLResult) and r_api.spec == spec
    _same_fit(r_api, _jax_fit(False, 3, 0.0))
    r_over = dtt.fit(tt.TVLSpec(K, n_rounds=2, tol=0.5), Y, backend=b3,
                     max_iters=SPEC["n_rounds"], tol=0.0)
    assert r_over.spec.n_rounds == SPEC["n_rounds"] and r_over.spec.tol == 0
    np.testing.assert_array_equal(r_over.logliks, r_api.logliks)
    r_tol = dtt.fit(tt.TVLSpec(K, n_rounds=SPEC["n_rounds"]), Y, backend=b3,
                    tol=STOP_TOL)
    _same_fit(r_tol, _jax_fit(False, 3, STOP_TOL))
    # The chunk length moves only the reads, not the numbers.
    _same_fit(dtt.fit(spec, Y, backend=CPU), _jax_fit(False, 3, 0.0))


def test_api_fit_tvl_init_and_options():
    Y = _panel()[0]
    spec = tt.TVLSpec(**SPEC, tol=0.0)
    with pytest.raises(TypeError, match="TVLParams"):
        dtt.fit(spec, Y, backend=CPU, init=np.eye(K))
    with pytest.raises(TypeError, match="warm_start"):
        dtt.fit(spec, Y, backend=CPU, warm_start=object())
    with pytest.raises(TypeError, match="session"):
        dtt.fit(spec, Y, backend=CPU, keep_session=True)
    with pytest.raises(TypeError, match="DynamicFactorModel or a TVLSpec"):
        dtt.fit(jt.TVLSpec(K), Y, backend=CPU)
    with pytest.raises(NotImplementedError, match="item 3"):
        tt.tvl_fit(Y, spec, device="cpu", callback=lambda *a: None)
    init = tt.TVLParams.from_numpy(_jax_fit(False, 1, 0.0).params)
    with pytest.warns(RuntimeWarning, match="fused"):
        r = dtt.fit(spec, Y, backend=CPU, init=init, fused=True)
    r_np = dtt.fit(spec, Y, backend=CPU, init=init.to_numpy())
    np.testing.assert_array_equal(r.logliks, r_np.logliks)
    rj = jt.tvl_fit(Y, jt.TVLSpec(**SPEC, tol=0.0),
                    init=_jax_fit(False, 1, 0.0).params, fused_chunk=1)
    close(r.logliks, rj.logliks, FIT_RTOL)


def test_tvl_params_round_trip():
    _, _, _, _, pj, pt = _inputs(True)
    back = pt.to_numpy()
    for name in tt.TVLParams._fields:
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(pj, name)))
    p32 = tt.TVLParams(*back).to("cpu", torch.float32)
    assert all(x.dtype == torch.float32 and x.is_contiguous() for x in p32)


def test_tvl_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    Y = np.where(_mask(T, N) > 0, _panel()[0], np.nan)
    res = dtt.fit(tt.TVLSpec(K, n_rounds=2, tol=0.0), Y, backend=CPU)
    assert len(res.logliks) == 2
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert {"tvl_obs_stats", "tvl_quad", "loading_filter",
            "loading_smoother"} <= set(kernels.LAUNCHES)


def test_simulate_tv_loadings_is_the_jax_copy():
    a = dgp.simulate_tv_loadings(7, 9, 2, np.random.default_rng(1), 0.05)
    from dfm_tpu_torch.utils import dgp as tdgp
    b = tdgp.simulate_tv_loadings(7, 9, 2, np.random.default_rng(1), 0.05)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
