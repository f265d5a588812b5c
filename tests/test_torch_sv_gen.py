"""The stochastic-volatility family past k = 16 and past 1,024 particles
(dfm_tpu_torch.models.sv) against ``dfm_tpu.models.sv`` at float64 on the
CPU, where K10-fwd and K10-ffbs run their plain twins, and the kernel
routes of the two entry points.

On the card ``sv_rbpf`` and ``sv_ffbs`` take K10's own kernels to k = 16
and 1,024 particles and their generic kernels past either (to k = 128, any
particle count), and raise at k = 129; here the twins run at any (k, M),
so these tests hold the arithmetic at k = 17, 20 and 33 (past the JAX
package's UNROLL_K_MAX = 8, where its filter factors with
jnp.linalg.cholesky and cho_solve) and at M = 1,100, on the JAX key
schedule's draws replayed into the port (``test_torch_sv``'s helpers),
and the routes by name.  Single passes agree to 1e-10 relative (``close``:
to the array's largest entry), fits to 1e-9; every filter panel resamples
at least once.  Each JAX result is computed once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.backends import cpu_ref as jref
from dfm_tpu.models import sv as jsv
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.models import sv as tsv
from dfm_tpu_torch.ssm.params import SSMParams
from test_torch_sv import _replay_ffbs, _replay_filter, _replay_fit, _t
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
T, N, M, S = 30, 40, 16, 6
SIGMA = 0.15
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _panel(k, T_=T, N_=N, seed=3):
    Y, _, _, p = dgp.simulate_sv(N_, T_, k, np.random.default_rng(seed))
    return Y, p


def _specs(k, M_=M, form="residual"):
    kw = dict(n_factors=k, n_particles=M_, n_smooth_draws=S,
              quad_form=form)
    return jsv.SVSpec(**kw), tsv.SVSpec(**kw)


@functools.lru_cache(maxsize=None)
def _jax_filter(k, M_, form, seed, T_=T):
    Y, p = _panel(k, T_=T_, seed=seed)
    js, _ = _specs(k, M_, form)
    return jsv.sv_filter(jnp.asarray(Y), JP.from_numpy(p, jnp.float64), js,
                         key=jax.random.PRNGKey(seed), sigma_h=SIGMA)


def _port_filter(k, M_, form, seed, T_=T):
    Y, p = _panel(k, T_=T_, seed=seed)
    _, ts = _specs(k, M_, form)
    return tsv.sv_filter(_t(Y), SSMParams.from_numpy(p), ts, sigma_h=SIGMA,
                         draws=_replay_filter(jax.random.PRNGKey(seed), T_,
                                              M_, k))


def _close_pass(rt, rj):
    assert int(rt.n_resamples) == int(rj.n_resamples) > 0
    close(rt.lls, rj.lls, PASS_RTOL)
    np.testing.assert_allclose(rt.loglik, float(rj.loglik), rtol=PASS_RTOL)
    for name in ("f_mean", "h_mean", "ess", "h_particles", "logw"):
        close(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
              PASS_RTOL)


@pytest.mark.parametrize("form", ["residual", "expanded"])
@pytest.mark.parametrize("k,seed", [(17, 5), (33, 7)])
def test_sv_filter_past_16_matches_jax(k, seed, form):
    _close_pass(_port_filter(k, M, form, seed), _jax_filter(k, M, form, seed))


def test_sv_smooth_h_past_16_matches_jax():
    k, seed = 33, 7
    ks = jax.random.PRNGKey(200 + k)
    Hj = jsv.sv_smooth_h(_jax_filter(k, M, "residual", seed), SIGMA, ks, S)
    Ht = tsv.sv_smooth_h(_port_filter(k, M, "residual", seed), SIGMA,
                         n_draws=S, draws=_replay_ffbs(ks, T, S, M))
    assert Ht.shape == (T, S, k)
    close(Ht.numpy(), np.asarray(Hj), PASS_RTOL)


def test_sv_pass_past_1024_particles_matches_jax():
    """k = 3 with M = 1,100 (the card's generic kernels past 1,024), the
    filter and FFBS."""
    k, M_, seed, T_ = 3, 1100, 11, 12
    rj = _jax_filter(k, M_, "residual", seed, T_)
    rt = _port_filter(k, M_, "residual", seed, T_)
    _close_pass(rt, rj)
    ks = jax.random.PRNGKey(300)
    Hj = jsv.sv_smooth_h(rj, SIGMA, ks, S)
    Ht = tsv.sv_smooth_h(rt, SIGMA, n_draws=S,
                         draws=_replay_ffbs(ks, T_, S, M_))
    close(Ht.numpy(), np.asarray(Hj), PASS_RTOL)


@functools.lru_cache(maxsize=None)
def _jax_fit():
    Y, _ = _panel(20, T_=40, N_=44, seed=13)
    js, _ = _specs(20)
    return jsv.sv_fit(Y, js, backend="tpu", em_iters=5, sv_iters=1)


def test_fit_at_k20_matches_jax(monkeypatch):
    """``dtt.fit(SVSpec(n_factors=20))`` (``max_iters`` is sv_iters) with
    each E-step's draws replayed from the JAX fit's key schedule."""
    Y, _ = _panel(20, T_=40, N_=44, seed=13)
    _, ts = _specs(20)
    rj = _jax_fit()
    replay = iter(_replay_fit(40, ts, 1, True))
    monkeypatch.setattr(tsv, "estep_draws", lambda *a: next(replay))
    rt = tsv.sv_fit(Y, ts, backend=CPU, em_iters=5, sv_iters=1)
    assert len(rt.logliks) == len(rj.logliks) == 2
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=FIT_RTOL)
    for name in ("sigma_h", "h_center", "h_smooth", "vol_paths"):
        close(getattr(rt, name), getattr(rj, name), FIT_RTOL)
    close(rt.result.f_mean.numpy(), np.asarray(rj.result.f_mean), FIT_RTOL)
    yt, ft = dtt.forecast(rt, 4)
    yj, fj, _ = jsv.sv_forecast(rj, 4)
    close(yt, yj, FIT_RTOL)
    close(ft, fj, FIT_RTOL)


def test_sigma0_limit_is_the_kalman_filter_of_the_jittered_q():
    """sigma_h = 0, h0_scale = 0 at k = 20: every particle carries h = log
    diag Q, and the reference's Lp = chol(sym(P_p) + 1e-6 I) makes the RBPF
    the exact Kalman filter of Q + 1e-6 I (predicting step 0 from (mu0,
    P0)): the JAX package's loglik and the port's agree with that oracle
    to 1e-10, while the jitter-free oracle's gap is the reference's own
    (the card's k = 25 contract is held to both, ``chip_smoke``)."""
    k = 20
    Y, p = _panel(k, seed=17)
    Qd = np.diag(np.diag(p.Q))
    Qj = Qd + 1e-6 * np.eye(k)
    p_diag = jref.SSMParams(p.Lam, p.A, Qd, p.R, p.mu0, p.P0)
    kw = dict(n_factors=k, n_particles=4, sigma_h=0.0, h0_scale=0.0)
    rj = jsv.sv_filter(jnp.asarray(Y), JP.from_numpy(p_diag, jnp.float64),
                       jsv.SVSpec(**kw), key=jax.random.PRNGKey(0))
    rt = tsv.sv_filter(_t(Y), SSMParams.from_numpy(p_diag), tsv.SVSpec(**kw),
                       generator=torch.Generator().manual_seed(0))
    ll = {name: jref.kalman_filter(Y, jref.SSMParams(
        p.Lam, p.A, Q, p.R, p.A @ p.mu0, p.A @ p.P0 @ p.A.T + Q)).loglik
        for name, Q in (("jitter", Qj), ("free", Qd))}
    for got in (float(rj.loglik), float(rt.loglik)):
        assert abs(got - ll["jitter"]) <= PASS_RTOL * abs(ll["jitter"])
    # The jitter-free oracle is farther off than the jittered one.
    assert (abs(float(rj.loglik) - ll["free"])
            > 10 * abs(float(rj.loglik) - ll["jitter"]))


# ------------------------------------------------------------- routes ---

ROUTES = {(16, 1024): ("sv_rbpf", "sv_ffbs"),
          (16, 1025): ("sv_rbpf_gen", "sv_ffbs_gen"),
          (17, 1024): ("sv_rbpf_gen", "sv_ffbs_gen"),
          (32, 1): ("sv_rbpf_gen", "sv_ffbs_gen"),
          (33, 64): ("sv_rbpf_gen", "sv_ffbs_gen"),
          (128, 1025): ("sv_rbpf_gen", "sv_ffbs_gen")}


@pytest.mark.parametrize("k,M_", sorted(ROUTES))
def test_sv_routes(k, M_):
    """K10's own kernels to k = 16 and 1,024 particles, the generic ones
    past either (same names in ``WIDE`` and ``GEN``), each in the generic
    source."""
    got = tuple(kernels.route_sv(n, k, M_) for n in ("sv_rbpf", "sv_ffbs"))
    assert got == ROUTES[(k, M_)]
    for name in got:
        assert name in kernels.KERNELS and name in kernels.LAUNCHES
    if got[0].endswith("_gen"):
        assert {kernels.KERNELS[n][0] for n in got} == {"sv_gen.cu"}


def _meta(*shape):
    """A tensor with no storage: a wrapper takes its kernel route for any
    device but the CPU, so a "meta" tensor reaches the range check without
    a card."""
    return torch.zeros(shape, device="meta")


def _meta_calls(k, M_, T_=4, N_=6):
    Y, L, v = _meta(T_, N_), _meta(N_, k), _meta(N_)
    kk, kv = _meta(k, k), _meta(k)
    fd = tsv.SVDraws(_meta(M_, k), _meta(T_, M_, k), _meta(T_))
    bd = tsv.FFBSDraws(_meta(2, M_), _meta(T_ - 1, 2, M_))
    return [lambda: fwd(Y, L, v, kk, None, kk, kv, kk, kv, kv, 0.1, fd, 0.5,
                        True, True)
            for fwd in (tsv.rbpf_scan, tsv.rbpf_scan_gen)] + [
        lambda: bwd(_meta(T_, M_, k), _meta(T_, M_), kv, bd)
        for bwd in (tsv.ffbs, tsv.ffbs_gen)]


@pytest.mark.parametrize("k,M_", sorted(ROUTES))
def test_generic_entries_take_the_generic_kernels(k, M_):
    """``rbpf_scan_gen`` and ``ffbs_gen`` give the generic kernels at every
    (k, M) the routes take, K10's own range too; the routing entries give
    ``route_sv``'s choice."""
    for name, want in zip(("sv_rbpf", "sv_ffbs"), ROUTES[(k, M_)]):
        assert tsv._route(name, k, M_, [], None, None, False) == want
        assert (tsv._route(name, k, M_, [], None, None, True)
                == kernels.GEN[name] == f"{name}_gen")


def test_generic_entries_run_the_twins_on_the_cpu():
    """On CPU tensors the generic entries are the plain twins, as the
    routing entries are."""
    k, M_, T_ = 3, 8, 12
    Y, p = _panel(k, T_=T_, N_=10)
    _, ts = _specs(k, M_)
    d = tsv.sv_draws(T_, M_, k, torch.float64, "cpu",
                     torch.Generator().manual_seed(5))
    P = SSMParams.from_numpy(p)
    C = P.Lam.T @ (P.Lam / P.R[:, None])
    sig, ctr = torch.full((k,), SIGMA, dtype=torch.float64), torch.zeros(
        k, dtype=torch.float64)
    args = (_t(Y), P.Lam, P.R, C, None, P.A, P.mu0, P.P0, ctr, sig, 1.0, d,
            0.5, True, True)
    plain = tsv.rbpf_scan_plain(*args)
    for got in (tsv.rbpf_scan(*args), tsv.rbpf_scan_gen(*args)):
        for a, b in zip(got, plain):
            assert (a is None and b is None) or torch.equal(a, b)
    bd = tsv.ffbs_draws(T_, S, M_, torch.float64, "cpu",
                        torch.Generator().manual_seed(6))
    want = tsv.ffbs_plain(plain[5], plain[6], sig, bd)
    for fn in (tsv.ffbs, tsv.ffbs_gen):
        assert torch.equal(fn(plain[5], plain[6], sig, bd), want)


@pytest.mark.parametrize("k,M_,exc", [(129, 64, NotImplementedError),
                                      (129, 2048, NotImplementedError),
                                      (5, 0, ValueError)])
def test_sv_wrappers_raise_before_any_launch(k, M_, exc):
    kernels.reset_launches()
    for call in _meta_calls(k, M_):
        with pytest.raises(exc) as err:
            call()
        if exc is NotImplementedError:
            assert kernels.GENERIC_K in str(err.value)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
