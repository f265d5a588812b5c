"""The port's mixed-frequency family (dfm_tpu_torch.models.mixed_freq and its
route through ``fit`` / ``forecast``) against ``dfm_tpu.models.mixed_freq``
at float64 on the CPU, where every kernel of the path (K2, the K4 pair and
K1, or their wide twins at m > 16; the K9 trio on the lowrank route) runs
its plain twin.

Two panels: m = 10 (30 monthly + 8 quarterly series, k = 2) and m = 25
(24 + 8, k = 5, S3's augmented width), T = 60, each with the quarterly
pattern, 10% scattered missing values, a ragged edge, a fully missing step
and a never-observed monthly series.  Single passes agree to 1e-10
relative (``close``: to the array's largest entry), fits to 1e-9.  The
lowrank route runs at rank min(4, k): above k, a step with no quarterly
observation has a rank-k C_t and the rank-r scan's Gam_t is singular but
for its jitter, where both packages lose the loglik to rounding.  The JAX
parameters cross by ``MFParams.from_numpy``; each JAX result is computed
once per module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.models import mixed_freq as jm
from dfm_tpu.ssm import info_filter as jinf
from dfm_tpu.utils import dgp
from dfm_tpu.utils.data import build_mask, standardize
from dfm_tpu_torch import kernels
from dfm_tpu_torch.models import mixed_freq as tm
from dfm_tpu_torch.ssm import info_filter as tinf
from torch_parity import close, one_torch_thread  # noqa: F401

PASS_RTOL, FIT_RTOL = 1e-10, 1e-9
T = 60
PANELS = {"m10": (30, 8, 2), "m25": (24, 8, 5)}
FULL_MISS, NEVER = 17, 2        # a fully missing step; a never-observed series
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)
ITERS, CHUNK = 6, 3
# tol = 2e-4 stops the m = 10 "seq" fit at its 5th loglik (relative steps
# 4.5e-2, 4.3e-3, 6.4e-4, 1.5e-4): inside the second chunk of 3.
STOP_TOL = 2e-4
CASES = [(pn, ts) for pn in PANELS for ts in ("seq", "lowrank")]
CASE_IDS = [f"{pn}-{ts}" for pn, ts in CASES]


@functools.lru_cache(maxsize=None)
def _panel(pn):
    """(Y with NaN at missing, mask) of panel ``pn``."""
    nm, nq, k = PANELS[pn]
    rng = np.random.default_rng(5)
    Y, mask, _, _ = dgp.simulate_mixed_freq(nm, nq, T, k, rng)
    W = mask * dgp.random_mask(T, nm + nq, rng, 0.1)
    W[T - 4:, :nm // 3] = 0.0            # ragged edge
    W[FULL_MISS] = 0.0
    W[:, NEVER] = 0.0
    return np.where(W > 0, Y, np.nan), W


def _specs(pn, ts="seq", **kw):
    nm, nq, k = PANELS[pn]
    kw = dict(n_monthly=nm, n_quarterly=nq, n_factors=k, time_scan=ts,
              rank=min(4, k), **kw)
    return jm.MixedFreqSpec(**kw), tm.MixedFreqSpec(**kw)


@functools.lru_cache(maxsize=None)
def _inputs(pn):
    """(standardized Y zero-filled at missing, mask, the JAX PCA init)."""
    Y, W = _panel(pn)
    Wm = build_mask(Y, W)
    Ys, _ = standardize(Y, mask=Wm)
    return (np.nan_to_num(Ys * (Wm > 0)), Wm,
            jm.mf_pca_init(Ys, Wm, _specs(pn)[0]))


_jax_core = jax.jit(jm.mf_em_core, static_argnums=(3,))


@functools.lru_cache(maxsize=None)
def _jax_pass(pn, ts):
    Yz, W, pj = _inputs(pn)
    with jax.default_matmul_precision("highest"):
        return _jax_core(jnp.asarray(Yz), jnp.asarray(W), pj,
                         _specs(pn, ts)[0])


@functools.lru_cache(maxsize=None)
def _jax_fit(pn, ts, tol=0.0):
    Y, W = _panel(pn)
    return jm.mf_fit(Y, _specs(pn, ts)[0], mask=W, max_iters=ITERS, tol=tol,
                     fused_chunk=CHUNK)


def _port_fit(pn, ts, tol=0.0, chunk=CHUNK):
    Y, W = _panel(pn)
    return tm.mf_fit(Y, _specs(pn, ts)[1], mask=W, max_iters=ITERS, tol=tol,
                     fused_chunk=chunk, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _same_params(pt, pj, rtol):
    for name in tm.MFParams._fields:
        close(np.asarray(getattr(pt, name)), np.asarray(getattr(pj, name)),
              rtol)


# ------------------------------------------------------------- passes ---

@pytest.mark.parametrize("pn", PANELS)
def test_augment_matches_jax(pn):
    _, _, pj = _inputs(pn)
    sj, st = _specs(pn)
    aj = jm.augment(pj, sj)
    at = tm.augment(tm.MFParams.from_numpy(pj), st)
    m = st.state_dim
    assert at.Lam.shape == (sum(PANELS[pn][:2]), m) and at.A.shape == (m, m)
    for name in ("Lam", "A", "Q", "R", "mu0", "P0"):
        np.testing.assert_array_equal(getattr(at, name).numpy(),
                                      np.asarray(getattr(aj, name)))


@pytest.mark.parametrize("pn", PANELS)
def test_mf_pca_init_matches_jax(pn):
    Y, W = _panel(pn)
    Wm = build_mask(Y, W)
    Ys, _ = standardize(Y, mask=Wm)
    sj, st = _specs(pn)
    _same_params(tm.mf_pca_init(Ys, Wm, st), jm.mf_pca_init(Ys, Wm, sj),
                 PASS_RTOL)


@pytest.mark.parametrize("pn,ts", CASES, ids=CASE_IDS)
def test_mf_em_core_matches_jax(pn, ts):
    """One constrained EM iteration: new params, the entry loglik and the
    smoothed moments."""
    Yz, W, pj = _inputs(pn)
    pnj, llj, smj = _jax_pass(pn, ts)
    pnt, llt, smt = tm.mf_em_core(_t(Yz), _t(W), tm.MFParams.from_numpy(pj),
                                  _specs(pn, ts)[1])
    assert llt.dtype == torch.float64
    close(float(llt), float(llj), PASS_RTOL)
    _same_params(pnt, pnj, PASS_RTOL)
    close(smt.x_sm.numpy(), smj.x_sm, PASS_RTOL)
    close(smt.P_sm.numpy(), smj.P_sm, PASS_RTOL)


@pytest.mark.parametrize("pn", PANELS)
def test_mf_em_scan_is_iterations_of_the_core(pn):
    Yz, W, pj = _inputs(pn)
    spec = _specs(pn)[1]
    Y, M, p0 = _t(Yz), _t(W), tm.MFParams.from_numpy(pj)
    p2, lls = tm.mf_em_scan(Y, M, p0, spec, 2)
    p1, ll0 = tm.mf_em_step(Y, M, p0, spec)
    p1b, ll1 = tm.mf_em_step(Y, M, p1, spec)
    assert lls.dtype == torch.float64 and lls.shape == (2,)
    np.testing.assert_array_equal(lls.numpy(), [float(ll0), float(ll1)])
    for a, b in zip(p2, p1b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    x_sm, P_sm, ll = tm._mf_smooth_impl(Y, M, p0, spec)
    assert float(ll) == float(ll0)
    close(x_sm.numpy(), _jax_pass(pn, "seq")[2].x_sm, PASS_RTOL)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_loglik_terms_local_matches_jax(masked):
    """quad_R and U from the residual (K1-wide's twin) at m = 25."""
    Yz, W, pj = _inputs("m25")
    aug = jm.augment(pj, _specs("m25")[0])
    xp = np.asarray(_jax_pass("m25", "seq")[2].x_sm)
    mask = W if masked else None
    qj, Uj = jinf.loglik_terms_local(jnp.asarray(Yz), aug.Lam, aug.R,
                                     jnp.asarray(xp),
                                     None if mask is None
                                     else jnp.asarray(mask))
    qt, Ut = tinf.loglik_terms_local(_t(Yz), _t(aug.Lam), _t(aug.R), _t(xp),
                                     None if mask is None else _t(mask))
    assert qt.dtype == torch.float64
    close(qt.numpy(), qj, PASS_RTOL)
    close(Ut.numpy(), Uj, PASS_RTOL)


@pytest.mark.parametrize("pn", PANELS)
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("precise", [True, False], ids=["precise", "fast"])
def test_mf_loglik_eval_matches_jax(pn, masked, precise):
    Yz, W, pj = _inputs(pn)
    sj, st = _specs(pn)
    mask = W if masked else None
    want = jm.mf_loglik_eval(Yz, mask, pj, sj, precise=precise)
    close(tm.mf_loglik_eval(Yz, mask, tm.MFParams.from_numpy(pj).to_numpy(),
                            st, precise=precise, device="cpu"), want,
          PASS_RTOL)
    close(tm.mf_loglik_eval(_t(Yz), None if mask is None else _t(mask),
                            tm.MFParams.from_numpy(pj), st,
                            precise=precise), want, PASS_RTOL)


# --------------------------------------------------------------- fits ---

def _same_fit(rt, rj):
    assert len(rt.logliks) == len(rj.logliks)
    assert rt.converged == rj.converged
    close(rt.logliks, rj.logliks, FIT_RTOL)
    _same_params(rt.params, rj.params, FIT_RTOL)
    for name in ("nowcast", "factors", "factor_cov", "state_T",
                 "state_cov_T"):
        close(getattr(rt, name), getattr(rj, name), FIT_RTOL)


@pytest.mark.parametrize("pn,ts", CASES, ids=CASE_IDS)
def test_mf_fit_matches_jax(pn, ts):
    rt = _port_fit(pn, ts)
    _same_fit(rt, _jax_fit(pn, ts))
    assert len(rt.logliks) == ITERS and not rt.converged
    nm, nq, k = PANELS[pn]
    assert rt.nowcast.shape == (T, nm + nq) and rt.factors.shape == (T, k)
    assert rt.state_T.shape == (5 * k,) and rt.health.ok
    assert all(isinstance(x, np.ndarray) for x in rt.params)


def test_mf_fit_stops_mid_chunk_like_jax():
    rt = _port_fit("m10", "seq", tol=STOP_TOL)
    _same_fit(rt, _jax_fit("m10", "seq", STOP_TOL))
    assert rt.converged and len(rt.logliks) == 5
    # The params embody exactly the 5 iterations the rule chose: the same
    # as a 5-iteration tol = 0 fit from the same start.
    Y, W = _panel("m10")
    ref = tm.mf_fit(Y, _specs("m10")[1], mask=W, max_iters=5, tol=0.0,
                    fused_chunk=5, device="cpu")
    _same_params(rt.params, ref.params, 0.0)
    np.testing.assert_array_equal(rt.logliks, ref.logliks)


def test_mf_forecast_matches_jax():
    rt, rj = _port_fit("m25", "seq"), _jax_fit("m25", "seq")
    yt, ft = tm.mf_forecast(rt, 12)
    yj, fj = jm.mf_forecast(rj, 12)
    assert yt.shape == (12, sum(PANELS["m25"][:2])) and ft.shape == (12, 5)
    close(yt, yj, FIT_RTOL)
    close(ft, fj, FIT_RTOL)
    y2, f2 = dtt.forecast(rt, 12)
    np.testing.assert_array_equal(y2, yt)
    np.testing.assert_array_equal(f2, ft)


def test_api_fit_routes_mixed_freq_spec_like_jax():
    """``fit(MixedFreqSpec)`` is ``mf_fit`` on the backend's dtype, device
    and fused_chunk, with ``fit``'s max_iters / tol (defaults 50, 1e-6)."""
    Y, W = _panel("m10")
    spec = _specs("m10")[1]
    b3 = dtt.TorchBackend(device="cpu", dtype=torch.float64,
                          fused_chunk=CHUNK)
    r_api = dtt.fit(spec, Y, mask=W, backend=b3, max_iters=ITERS, tol=0.0)
    assert isinstance(r_api, tm.MFResult) and r_api.spec == spec
    r_mf = _port_fit("m10", "seq")
    np.testing.assert_array_equal(r_api.logliks, r_mf.logliks)
    np.testing.assert_array_equal(r_api.nowcast, r_mf.nowcast)
    _same_fit(r_api, _jax_fit("m10", "seq"))
    # The chunk length moves only the reads, not the numbers.
    _same_fit(dtt.fit(spec, Y, mask=W, backend=CPU, max_iters=ITERS,
                      tol=0.0), _jax_fit("m10", "seq"))
    init = tm.MFParams.from_numpy(_jax_fit("m10", "seq").params)
    with pytest.warns(RuntimeWarning, match="fused"):
        r = dtt.fit(spec, Y, mask=W, backend=b3, max_iters=2, tol=0.0,
                    init=init, fused=True)
    r_np = dtt.fit(spec, Y, mask=W, backend=b3, max_iters=2, tol=0.0,
                   init=init.to_numpy())
    np.testing.assert_array_equal(r.logliks, r_np.logliks)


def test_mf_routes_and_options_that_raise():
    """The square-root route runs (its JAX parity is
    tests/test_torch_qr_gen.py's): at the same entry params its loglik is
    the sequential route's, and a 2-iteration fit is finite; the options
    not ported raise."""
    Y, W = _panel("m10")
    Yz, M, pj = _inputs("m10")
    p0 = tm.MFParams.from_numpy(pj)
    _, ll_qr, _ = tm.mf_em_core(_t(Yz), _t(M), p0, _specs("m10", "pit_qr")[1])
    _, ll_seq, _ = tm.mf_em_core(_t(Yz), _t(M), p0, _specs("m10")[1])
    np.testing.assert_allclose(float(ll_qr), float(ll_seq), rtol=FIT_RTOL)
    res = dtt.fit(_specs("m10", "pit_qr")[1], Y, mask=W, backend=CPU,
                  max_iters=2, tol=0.0)
    assert len(res.logliks) == 2 and np.isfinite(res.logliks).all()
    spec = _specs("m10")[1]
    with pytest.raises(NotImplementedError, match="item 3"):
        tm.mf_fit(Y, spec, mask=W, device="cpu", callback=lambda *a: None)
    with pytest.raises(TypeError, match="MFParams"):
        dtt.fit(spec, Y, mask=W, backend=CPU, init=np.eye(2))
    with pytest.raises(TypeError, match="warm_start"):
        dtt.fit(spec, Y, mask=W, backend=CPU, warm_start=object())
    with pytest.raises(TypeError, match="session"):
        dtt.fit(spec, Y, mask=W, backend=CPU, keep_session=True)
    with pytest.raises(TypeError, match="MixedFreqSpec"):
        dtt.fit(_specs("m10")[0], Y, mask=W, backend=CPU)
    with pytest.raises(ValueError, match="time_scan"):
        tm.MixedFreqSpec(3, 2, 2, time_scan="dense")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.mf_fit(Y, spec, mask=W)


def test_mf_params_round_trip():
    _, _, pj = _inputs("m25")
    pt = tm.MFParams.from_numpy(pj)
    back = pt.to_numpy()
    for name in tm.MFParams._fields:
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(pj, name)))
    p32 = tm.MFParams(*back).to("cpu", torch.float32)
    assert all(x.dtype == torch.float32 and x.is_contiguous() for x in p32)
    assert dataclasses.replace(_specs("m25")[1]).state_dim == 25


# ------------------------------------------------------ kernel ranges ---

WIDE_NAMES = ("obs_stats", "info_scan", "quad_local", "rts_smoother")


@pytest.mark.parametrize("k,want", [(1, "lone"), (16, "lone"), (17, "wide"),
                                    (25, "wide"), (32, "wide")])
def test_wide_routing_ranges(k, want):
    """The four lone entry points: today's kernel for k <= 16, the wide
    kernel (same source file) for 16 < k <= 32."""
    for name in WIDE_NAMES:
        got = kernels.route(name, k)
        assert got == (name if want == "lone" else kernels.WIDE[name])
        assert kernels.KERNELS[got][0] == kernels.KERNELS[name][0]


def test_past_the_wide_range_raises_naming_the_roadmap_row():
    """The four lone entry points take their generic kernel (same source
    file; the K4 pair's in ``info_scan_gen.cu``, a source of its own) from
    33 to 128 and raise at 129; the wide K1's own range check still stops
    at 32 (``loglik_terms_local`` routes past it to K1-gen)."""
    for name in WIDE_NAMES:
        got = kernels.route(name, 33)
        assert got == kernels.GEN[name]
        assert kernels.KERNELS[got][0] == (
            "info_scan_gen.cu" if name in ("info_scan", "rts_smoother")
            else kernels.KERNELS[name][0])
        with pytest.raises(NotImplementedError, match="Generic k"):
            kernels.route(name, 129)
        with pytest.raises(ValueError):
            kernels.route(name, 0)
    kernels.check_k("quad_local_wide", 32, kernels.WIDE_KMAX)
    with pytest.raises(NotImplementedError, match="Generic k"):
        kernels.check_k("quad_local_wide", 33, kernels.WIDE_KMAX)
    # Every other kernel stops at 16, but K3, K5a and K10 (K10-fwd and
    # K10-ffbs), whose kernels past 16 take 16 < k <= 32 and 32 < k <= 128
    # (K10's one generic kernel both): all stop at 129.
    for name in ("batched_info_scan",):
        with pytest.raises(NotImplementedError, match="Generic k"):
            kernels.check_k(name, 17)
    for name, kmax in (("mstep_rows", kernels.GEN_KMAX),
                       ("ss_cov_path", kernels.GEN_KMAX),
                       ("sv_rbpf", kernels.GEN_KMAX),
                       ("sv_ffbs", kernels.GEN_KMAX)):
        assert kernels.route(name, 17) == kernels.WIDE[name]
        with pytest.raises(NotImplementedError, match="Generic k"):
            kernels.route(name, kmax + 1)


def test_mf_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    Y, W = _panel("m25")
    for ts in ("seq", "lowrank"):
        res = dtt.fit(_specs("m25", ts)[1], Y, mask=W, backend=CPU,
                      max_iters=2, tol=0.0)
        assert len(res.logliks) == 2
    tm.mf_loglik_eval(_inputs("m25")[0], W, res.params, res.spec,
                      device="cpu")
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert set(kernels.WIDE.values()) <= set(kernels.LAUNCHES)


def test_mixed_freq_dgp_is_the_jax_copy():
    from dfm_tpu_torch.utils import dgp as tdgp
    a = dgp.simulate_mixed_freq(7, 3, 12, 2, np.random.default_rng(1))
    b = tdgp.simulate_mixed_freq(7, 3, 12, 2, np.random.default_rng(1))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    for key in a[3]:
        np.testing.assert_array_equal(a[3][key], b[3][key])
    np.testing.assert_array_equal(
        dgp.random_mask(9, 4, np.random.default_rng(2), 0.3),
        tdgp.random_mask(9, 4, np.random.default_rng(2), 0.3))
    np.testing.assert_array_equal(dgp.mixed_freq_mask(9, 4, 2),
                                  tdgp.mixed_freq_mask(9, 4, 2))
