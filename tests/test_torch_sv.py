"""The port's stochastic-volatility family (dfm_tpu_torch.models.sv and its
route through ``fit``) against ``dfm_tpu.models.sv`` at float64 on the CPU,
where K10-fwd and K10-ffbs run their plain twins.

torch cannot reproduce ``jax.random``'s bits, so the port takes its noise
as explicit draws.  ``_replay_filter`` and ``_replay_ffbs`` rebuild the
JAX package's key schedule (``_rbpf_scan``: ``k0, k1 = split(key)``, the
h_0 normals from k0, then per step ``key, kh, kr = split(key, 3)``, the
walk's normals from kh and the resampling uniform from kr; ``_ffbs_impl``:
``kT, kb = split(key)``, Gumbels from kT, then ``split(kb, T - 1)``, row t
for step t; ``sv_fit``: ``key, k_ = split(key)`` an E-step, ``kf, ks =
split(k_)``) and hand the draws to the port, so both packages run on the
same numbers.  Single passes agree to 1e-10 relative (``close``: to the
array's largest entry), fits to 1e-9; every panel resamples at least once,
so the resampling path is compared too.
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
from dfm_tpu_torch.ssm.info_filter import loglik_eval
from dfm_tpu_torch.ssm.params import SSMParams
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
T, N, M, S = 50, 30, 32, 8
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.tensor(np.asarray(a))


def _replay_filter(key, T_, M_, k):
    """The JAX filter's draws from ``key`` (``_rbpf_scan``'s schedule)."""
    k0, key = jax.random.split(key)
    h0 = jax.random.normal(k0, (M_, k), jnp.float64)
    xi, u = [], []
    for _ in range(T_):
        key, kh, kr = jax.random.split(key, 3)
        xi.append(jax.random.normal(kh, (M_, k), jnp.float64))
        u.append(jax.random.uniform(kr, (), dtype=jnp.float64))
    return tsv.SVDraws(_t(h0), _t(np.stack(xi)), _t(np.stack(u)))


def _replay_ffbs(key, T_, S_, M_):
    """The JAX backward sampler's Gumbels from ``key`` (``_ffbs_impl``)."""
    kT, kb = jax.random.split(key)
    g_last = jax.random.gumbel(kT, (S_, M_), jnp.float64)
    keys = jax.random.split(kb, T_ - 1)
    g = [jax.random.gumbel(keys[t], (S_, M_), jnp.float64)
         for t in range(T_ - 1)]
    return tsv.FFBSDraws(_t(g_last), _t(np.stack(g)))


def _replay_fit(T_, spec, n_iters, estimate_sv):
    """Every E-step's draws of a JAX ``sv_fit`` with the default key."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(n_iters + 1 if estimate_sv else 1):
        key, k_ = jax.random.split(key)
        kf, ks = jax.random.split(k_)
        out.append((_replay_filter(kf, T_, spec.n_particles,
                                   spec.n_factors),
                    _replay_ffbs(ks, T_, spec.n_smooth_draws,
                                 spec.n_particles) if estimate_sv else None))
    return out


@functools.lru_cache(maxsize=None)
def _panel(k, T_=T, N_=N, seed=3):
    """(Y, DGP params) of the SV DGP (``simulate_sv``, S5's)."""
    Y, _, _, p = dgp.simulate_sv(N_, T_, k, np.random.default_rng(seed))
    return Y, p


def _specs(k, form="residual", **kw):
    kw = dict(n_factors=k, n_particles=M, n_smooth_draws=S, quad_form=form,
              **kw)
    return jsv.SVSpec(**kw), tsv.SVSpec(**kw)


@functools.lru_cache(maxsize=None)
def _jax_filter(k, form, seed):
    Y, p = _panel(k, seed=seed)
    js, _ = _specs(k, form)
    return jsv.sv_filter(jnp.asarray(Y), JP.from_numpy(p, jnp.float64), js,
                         key=jax.random.PRNGKey(seed), sigma_h=0.15)


def _port_filter(k, form, seed):
    Y, p = _panel(k, seed=seed)
    _, ts = _specs(k, form)
    return tsv.sv_filter(_t(Y), SSMParams.from_numpy(p), ts, sigma_h=0.15,
                         draws=_replay_filter(jax.random.PRNGKey(seed), T,
                                              M, k))


# k = 9 takes the Cholesky branch past UNROLL_K_MAX = 8.
@pytest.mark.parametrize("form", ["residual", "expanded"])
@pytest.mark.parametrize("k,seed", [(1, 11), (3, 3), (9, 5)])
def test_sv_filter_matches_jax(k, seed, form):
    rj, rt = _jax_filter(k, form, seed), _port_filter(k, form, seed)
    assert int(rt.n_resamples) == int(rj.n_resamples) > 0
    close(rt.lls, rj.lls, PASS_RTOL)
    np.testing.assert_allclose(rt.loglik, float(rj.loglik), rtol=PASS_RTOL)
    for name in ("f_mean", "h_mean", "ess", "h_particles", "logw"):
        close(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
              PASS_RTOL)


@pytest.mark.parametrize("k,seed", [(3, 3), (9, 5)])
def test_sv_smooth_h_matches_jax(k, seed):
    ks = jax.random.PRNGKey(100 + k)
    Hj = jsv.sv_smooth_h(_jax_filter(k, "residual", seed), 0.15, ks, S)
    Ht = tsv.sv_smooth_h(_port_filter(k, "residual", seed), 0.15,
                         n_draws=S, draws=_replay_ffbs(ks, T, S, M))
    assert Ht.shape == (T, S, k)
    close(Ht.numpy(), np.asarray(Hj), PASS_RTOL)


@functools.lru_cache(maxsize=None)
def _jax_fit(estimate_sv):
    Y, _ = _panel(2, T_=60, N_=40, seed=7)
    js, _ = _specs(2)
    return jsv.sv_fit(Y, js, backend="tpu", sv_iters=2,
                      estimate_sv=estimate_sv)


@pytest.mark.parametrize("estimate_sv", [True, False],
                         ids=["estimate", "fixed"])
def test_sv_fit_through_fit_matches_jax(estimate_sv, monkeypatch):
    """``dtt.fit(SVSpec)`` (the api route; ``max_iters`` is sv_iters)
    with each E-step's draws replayed from the JAX fit's key schedule."""
    Y, _ = _panel(2, T_=60, N_=40, seed=7)
    _, ts = _specs(2)
    rj = _jax_fit(estimate_sv)
    if estimate_sv:
        replay = iter(_replay_fit(60, ts, 2, True))
        monkeypatch.setattr(tsv, "estep_draws", lambda *a: next(replay))
        rt = dtt.fit(ts, Y, backend=CPU, max_iters=2)
    else:
        rt = tsv.sv_fit(Y, ts, backend=CPU, sv_iters=2, estimate_sv=False,
                        draws=_replay_fit(60, ts, 2, False))
    assert isinstance(rt, dtt.SVFit)
    assert len(rt.logliks) == len(rj.logliks) == (3 if estimate_sv else 1)
    np.testing.assert_allclose(rt.logliks, rj.logliks, rtol=FIT_RTOL)
    for name in ("sigma_h", "h_center", "h_smooth", "vol_paths"):
        close(getattr(rt, name), getattr(rj, name), FIT_RTOL)
    close(rt.result.f_mean.numpy(), np.asarray(rj.result.f_mean), FIT_RTOL)
    close(rt.params.Lam, rj.params.Lam, FIT_RTOL)
    close(rt.standardizer.scale, rj.standardizer.scale, FIT_RTOL)
    assert rt.health.ok == rj.health.ok


def test_forecast_of_an_svfit():
    Y, _ = _panel(2, T_=60, N_=40, seed=7)
    _, ts = _specs(2)
    rt = tsv.sv_fit(Y, ts, backend=CPU, sv_iters=2,
                    draws=_replay_fit(60, ts, 2, True))
    rj = _jax_fit(True)
    y, f = dtt.forecast(rt, 6)
    assert y.shape == (6, 40) and f.shape == (6, 2)
    yj, fj, vj = jsv.sv_forecast(rj, 6)
    close(y, yj, FIT_RTOL)
    close(f, fj, FIT_RTOL)
    close(tsv.sv_forecast(rt, 6)[2], vj, FIT_RTOL)


def test_linear_gaussian_limit_is_the_kalman_loglik():
    """sigma_h = 0, h0_scale = 0: every particle carries h = log diag Q,
    so the RBPF loglik is the exact Kalman loglik of the model with Q =
    diag(diag Q): the NumPy oracle and the port's f64 info filter."""
    rng = np.random.default_rng(41)
    p = dgp.dfm_params(20, 3, rng)
    Y, _ = dgp.simulate(p, 80, rng)
    spec = tsv.SVSpec(n_factors=3, n_particles=8, sigma_h=0.0, h0_scale=0.0)
    res = tsv.sv_filter(_t(Y), SSMParams.from_numpy(p), spec,
                        generator=torch.Generator().manual_seed(1))
    p_diag = jref.SSMParams(p.Lam, p.A, np.diag(np.diag(p.Q)), p.R, p.mu0,
                            p.P0)
    ll_kf = jref.kalman_filter(Y, p_diag).loglik
    assert abs(float(res.loglik) - ll_kf) < 1e-7 * abs(ll_kf)
    ll_port = loglik_eval(Y, p_diag, device="cpu")
    assert abs(float(res.loglik) - ll_port) < 1e-7 * abs(ll_port)


def test_draws_are_deterministic_under_a_generator_seed():
    Y, p = _panel(3, seed=3)
    _, ts = _specs(3)
    run = lambda seed: tsv.sv_filter(_t(Y), SSMParams.from_numpy(p), ts,
                                     generator=torch.Generator()
                                     .manual_seed(seed))
    a, b, c = run(4), run(4), run(5)
    assert a.loglik == b.loglik
    assert torch.equal(a.h_particles, b.h_particles)
    assert a.loglik != c.loglik
    g = tsv.ffbs_draws(T, S, M, torch.float64, "cpu",
                       torch.Generator().manual_seed(0))
    assert g.g.shape == (T - 1, S, M) and bool(torch.isfinite(g.g).all())


@pytest.mark.parametrize("case", ["mask", "nan", "init"])
def test_fit_rejects_what_the_sv_family_does_not_take(case):
    Y, _ = _panel(2, T_=30, N_=20, seed=8)
    _, ts = _specs(2)
    kw = {}
    if case == "mask":
        kw["mask"] = np.ones_like(Y)
    elif case == "nan":
        Y = Y.copy()
        Y[3, 4] = np.nan
    else:
        kw["init"] = object()
    with pytest.raises(ValueError):
        dtt.fit(ts, Y, backend=CPU, max_iters=1, **kw)


@pytest.mark.parametrize("k,M_,want", [(16, 1024, ("sv_rbpf", "sv_ffbs")),
                                       (129, 64, NotImplementedError),
                                       (3, 1025,
                                        ("sv_rbpf_gen", "sv_ffbs_gen")),
                                       (3, 0, ValueError)])
def test_kernel_range_checks(k, M_, want):
    """The CUDA wrappers route by (k, M) (``kernels.route_sv``): K10's own
    kernels to k = 16 and 1,024 particles, the generic ones past either;
    k = 129 raises, naming the ROADMAP row, and M < 1 is an error."""
    if isinstance(want, tuple):
        assert tuple(kernels.route_sv(n, k, M_)
                     for n in ("sv_rbpf", "sv_ffbs")) == want
        return
    with pytest.raises(want) as err:
        kernels.route_sv("sv_rbpf", k, M_)
    if want is NotImplementedError:
        assert "ROADMAP Queue 2" in str(err.value)


def test_mesh_is_not_ported():
    Y, _ = _panel(2, T_=30, N_=20, seed=8)
    with pytest.raises(NotImplementedError, match="item 12"):
        tsv.sv_fit(Y, _specs(2)[1], backend=CPU, mesh=object())


def test_fit_names_every_family_it_takes():
    with pytest.raises(TypeError, match="SVSpec"):
        dtt.fit(object(), np.zeros((10, 5)), backend=CPU)
