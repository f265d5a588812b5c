"""dfm_tpu_torch.estim.em against dfm_tpu.estim.em and the NumPy oracle.

Single M-steps compare at 1e-10 relative (same closed forms, one pass).
The 20-iteration paths compare logliks at 1e-9 relative against the JAX
fused scan: EM carries each iteration's rounding into the next one's
params, and over 20 iterations the measured gap stays below 1e-11, so
1e-9 leaves two orders of margin.  Against ``cpu_ref.em_fit`` (the dense
NumPy oracle, a different filter) the paths agree to 1e-8 relative, the
tolerance the JAX package's own backend-parity tests use for EM paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.backends import cpu_ref as jcpu
from dfm_tpu.estim import em as jem
from dfm_tpu.ssm import info_filter as jif
from dfm_tpu.ssm import kalman as jk
from dfm_tpu.ssm.params import SSMParams as JP
from dfm_tpu.utils import dgp
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.ssm import info_filter as tif
from dfm_tpu_torch.ssm import kalman as tk
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-10


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(3)
    p = dgp.dfm_params(41, 3, rng)
    Y, _ = dgp.simulate(p, 60, rng)
    W = (rng.random(Y.shape) >= 0.2).astype(np.float64)
    W[:, 4] = 0.0                               # a never-observed series
    W[9] = 0.0                                  # a fully missing time step
    p0 = jcpu.pca_init(Y, 3, mask=W)
    return p, Y, W, np.where(W > 0, Y, np.nan), p0


@pytest.fixture(scope="module")
def s1():
    """Config S1 (bench/configs.py): 2-factor static DFM, 50 x 200."""
    rng = np.random.default_rng(0)
    p = dgp.dfm_params(50, 2, rng, static=True)
    Y, _ = dgp.simulate(p, 200, rng)
    return Y, jcpu.pca_init(Y, 2, static=True)


def _smoothed(panel, masked):
    p, Y, W, Ynan, _ = panel
    Yin = Ynan if masked else Y
    Wj = jnp.asarray(W) if masked else None
    Wt = torch.as_tensor(W) if masked else None
    pj, pt = JP.from_numpy(p, jnp.float64), TP.from_numpy(p)
    smj = jk.rts_smoother(jif.info_filter(jnp.asarray(Yin), pj, mask=Wj), pj)
    smt = tk.rts_smoother(tif.info_filter(torch.as_tensor(Yin), pt, mask=Wt),
                          pt)
    return Yin, Wj, Wt, pj, pt, smj, smt


@pytest.mark.parametrize("masked,ridge", [(False, None), (False, 0.3),
                                          (True, None), (True, 0.3)])
def test_mstep_rows(panel, masked, ridge):
    Yin, Wj, Wt, _, _, smj, smt = _smoothed(panel, masked)
    EffT_j, _ = jem.moments(smj)
    EffT_t, _ = tem.moments(smt)
    S_j = EffT_j.sum(0)
    S_t = EffT_t.sum(0)
    Lj, Rj = jem.mstep_rows(jnp.asarray(Yin), Wj, smj.x_sm, EffT_j, smj.P_sm,
                            S_j, 1e-6, lam_ridge=ridge)
    Lt, Rt = tem.mstep_rows(torch.as_tensor(Yin), Wt, smt.x_sm, EffT_t,
                            smt.P_sm, S_t, 1e-6, lam_ridge=ridge)
    close(Lt, Lj, RTOL)
    close(Rt, Rj, RTOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dynamics", ["ar1", "static"])
def test_m_step(panel, masked, dynamics):
    Yin, Wj, Wt, pj, pt, smj, smt = _smoothed(panel, masked)
    est = dynamics == "ar1"
    kw = dict(estimate_A=est, estimate_Q=est, filter="info")
    Yj, Yt = jnp.asarray(Yin), torch.as_tensor(Yin)
    Ysq_j = None if masked else jnp.einsum("ti,ti->i", Yj, Yj)
    Ysq_t = None if masked else torch.einsum("ti,ti->i", Yt, Yt)
    got = tem._m_step(Yt, Wt, smt, pt, tem.EMConfig(**kw), Ysq=Ysq_t)
    want = jem._m_step(Yj, Wj, smj, pj, jem.EMConfig(**kw), Ysq=Ysq_j)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        close(g, w, RTOL)


def test_s1_twenty_iteration_path(s1):
    Y, p0 = s1
    kw = dict(estimate_A=False, estimate_Q=False, filter="info")
    pj, lls_j, _ = jem.em_fit_scan(jnp.asarray(Y), JP.from_numpy(p0,
                                   jnp.float64), 20, cfg=jem.EMConfig(**kw))
    ps, lls_t, _ = tem.em_fit_scan(torch.as_tensor(Y), TP.from_numpy(p0), 20,
                                   cfg=tem.EMConfig(**kw))
    lls_t = lls_t.numpy()
    np.testing.assert_allclose(lls_t, np.asarray(lls_j), rtol=1e-9)
    for g, w in zip(ps[-1], pj):
        close(g, w, rtol=1e-9)
    assert np.all(np.diff(lls_t) >= -1e-8 * np.abs(lls_t[1:]))
    _, lls_np, _ = jcpu.em_fit(Y, p0, max_iters=20, tol=0.0,
                               estimate_A=False, estimate_Q=False)
    np.testing.assert_allclose(lls_t, lls_np, rtol=1e-8)


@pytest.mark.parametrize("masked,chunk", [(False, 5), (True, 3)])
def test_chunked_driver_stops_like_the_reference(panel, masked, chunk):
    """tol = 1e-6 stops mid-chunk: the returned params must embody the
    same update count as the JAX package's chunk-prefix replay."""
    _, Y, W, Ynan, p0 = panel
    Yz = np.where(W > 0, Ynan, 0.0) if masked else Y
    cfg_t = tem.EMConfig(filter="info")
    pt, lls_t, conv_t, it_t, secs, max_delta = tem.fit_em_chunked(
        torch.as_tensor(Yz), torch.as_tensor(W) if masked else None,
        TP.from_numpy(p0), cfg_t, 40, 1e-6, fused_chunk=chunk)
    cfg_j = jem.EMConfig(filter="info")
    Yj, Wj = jnp.asarray(Yz), (jnp.asarray(W) if masked else None)

    def scan_fn(pp, n):
        return jem.em_fit_scan(Yj, pp, n, mask=Wj, cfg=cfg_j)[:2] + (None,)

    pj, lls_j, conv_j, it_j = jem.run_em_chunked(
        scan_fn, JP.from_numpy(p0, jnp.float64), 40, 1e-6,
        jem.noise_floor_for(jnp.float64, Yj.size), fused_chunk=chunk)
    assert (conv_t, it_t, len(lls_t)) == (conv_j, it_j, len(lls_j))
    assert conv_t and it_t % chunk != 0        # a mid-chunk stop
    assert max_delta == 0.0                    # no freeze outside ss
    assert len(secs) == len(lls_t)
    assert sum(x > 0 for x in secs) == -(-len(lls_t) // chunk)
    np.testing.assert_allclose(lls_t, np.asarray(lls_j), rtol=1e-9)
    for g, w in zip(pt, pj):
        close(g, w, rtol=1e-9)


@pytest.mark.parametrize("lls,tol,floor,monotone", [
    ([1.0], 1e-6, 0.0, True),
    ([-100.0, -90.0], 1e-6, 0.0, True),
    ([-100.0, -100.00001], 1e-6, 0.0, True),
    ([-100.0, -101.0], 0.0, 0.5, True),
    ([-100.0, -100.2], 0.0, 0.5, True),
    ([-100.0, -100.2], 1e-9, 0.5, True),
    ([-100.0, -101.0], 1e-9, 0.5, False),
])
def test_em_progress_and_noise_floor(lls, tol, floor, monotone):
    assert (tem.em_progress(lls, tol, floor, monotone=monotone)
            == jem.em_progress(lls, tol, floor, monotone=monotone))
    assert (tem.noise_floor_for(torch.float32, 5e6)
            == jem.noise_floor_for(jnp.float32, 5e6))


@pytest.mark.parametrize("flt", ["ss", "pit", "pit_qr", "lowrank"])
def test_ported_engines_construct_and_match_one_e_step(panel, flt):
    """Unmasked for ss (masked would fall back to info), masked for pit,
    pit_qr and lowrank (auto rank: r = k = 3); tau = 12 keeps T = 60
    above the ss fallback (2 tau + 4)."""
    p, Y, W, Ynan, _ = panel
    masked = flt in ("pit", "pit_qr", "lowrank")
    Yin = np.where(W > 0, Ynan, 0.0) if masked else Y
    cfg_t = tem.EMConfig(filter=flt, tau=12)
    cfg_j = jem.EMConfig(filter=flt, tau=12)
    kt, smt, dt_ = cfg_t.e_step(torch.as_tensor(Yin), 
                                torch.as_tensor(W) if masked else None,
                                TP.from_numpy(p))
    kj, smj, dj = cfg_j.e_step(jnp.asarray(Yin),
                               jnp.asarray(W) if masked else None,
                               JP.from_numpy(p, jnp.float64))
    np.testing.assert_allclose(float(kt.loglik), float(kj.loglik), rtol=RTOL)
    close(kt.x_filt, kj.x_filt, RTOL)
    close(smt.x_sm, smj.x_sm, RTOL)
    close(smt.P_sm, smj.P_sm, RTOL)
    assert float(dt_) == pytest.approx(float(dj), abs=1e-14)


@pytest.mark.parametrize("flt", ["dense", "info", "ss", "pit", "pit_qr",
                                 "lowrank"])
def test_engine_function_pairs_match_the_reference(flt):
    """filter_fn / smoother_fn / report_pair name the same routines as the
    JAX package's (the reporting pair: pit_qr and lowrank through
    themselves, ss and pit through the exact info pair); lowrank's are
    partials that carry the rank."""
    cfg_t = tem.EMConfig(filter=flt, rank=2)
    cfg_j = jem.EMConfig(filter=flt, rank=2)

    def names(fns):
        return [getattr(f, "func", f).__name__ for f in fns]

    assert names(cfg_t.report_pair()) == names(cfg_j.report_pair())
    assert names([cfg_t.smoother_fn()]) == names([cfg_j.smoother_fn()])
    if flt != "ss":
        assert names([cfg_t.filter_fn()]) == names([cfg_j.filter_fn()])
    if flt == "lowrank":
        assert cfg_t.filter_fn().keywords == cfg_j.filter_fn().keywords \
            == {"rank": 2}
