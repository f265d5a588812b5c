"""The batched paths past k = 32, where the card takes the generic twins of
K4b (both passes), K1b, K6b, K2b-m, K1b-m and K3b-m, against dfm_tpu at
float64 on the CPU.

The CPU runs each kernel's plain twin, which takes any k, so these tests
hold the batched paths' algebra at k = 34 (k = 33 for the rolling windows,
k = 40 for the masked serving twins and the row solve) against the JAX
package: ``fit_many`` restarts, a Hetero ``run_batched_em`` (one lane
ragged in T, one in N), the masked serving twins on a bucket with a fully
masked step, a k = 20 lane padded across 32 and never-observed N-pad
series, ``_bsolve_rows``, the k-grid with a lane padded across 32, the
rolling windows with an info seed fit, and an info and a lowrank fleet of
a k = 34 and a k = 20 tenant.  The EM paths agree to 1e-9 relative (each
iteration carries ~1e-13 rounding into the next params), single passes to
1e-10.  ``kernels.route`` sends the seven batched entry points to their
``_gen`` kernel (same source) for 33..128 and raises
``NotImplementedError`` naming the ROADMAP row at 129.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu
import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.estim import batched as jb
from dfm_tpu.estim import em as jem
from dfm_tpu.estim.evaluate import oos_evaluate as joos
from dfm_tpu.estim.select import select_n_factors_em as jselect
from dfm_tpu.utils import dgp
from dfm_tpu_torch import kernels
from dfm_tpu_torch.backends import cpu_ref as tcpu
from dfm_tpu_torch.estim import batched as tb
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.utils.data import standardize
from test_torch_batched_wide import (BATCHED, CPU64, JB64, RTOL,
                                     _assert_batch_matches, _panel, _t)
from test_torch_fleet import KW as FLEET_KW
from test_torch_fleet import _assert_update_matches, _tenant
from torch_parity import close, one_torch_thread  # noqa: F401

K = 34
KS = 40                        # the serving twins' and row solve's k


# ---------------------------------------------------- batched fits --

def test_fit_many_restarts_at_k34_matches_jax():
    """Three restarts of one 60 x 40 panel at k = 34 (the port's jittered
    inits on both sides), 3 iterations, tol = 0."""
    Y = _panel(60, 40, K, 1401)
    spec = dtt.DFMBatchSpec.restarts(dtt.DynamicFactorModel(K), Y, 3)
    rj = jb.fit_many(jb.DFMBatchSpec(Y=spec.Y, model=JModel(K),
                                     inits=spec.inits),
                     max_iters=3, tol=0.0, dtype=np.float64, robust=False)
    rt = dtt.fit_many(spec, backend=CPU64, max_iters=3, tol=0.0)
    _assert_batch_matches(rt, rj)
    assert all(len(t) == 3 for t in rt.logliks)


def test_run_batched_em_hetero_at_k34_matches_jax():
    """A Hetero bucket at k = 34: lane 1 ragged in T (45 of 60 steps; the
    t_seq freeze), lane 2 in N (36 of 40 series), each from its own PCA
    init; 5 iterations in chunks of 3."""
    Z = standardize(_panel(60, 40, K, 1402))[0]
    T_act, N_act = (60, 45, 60), (40, 40, 36)
    Ys, ps = [], []
    for t, n in zip(T_act, N_act):
        Ys.append(tb.pad_panel_to_n(tb.pad_panel_to_t(Z[:t, :n], 60), 40))
        ps.append(tb.pad_params_to_n(tcpu.pca_init(Z[:t, :n], K), 40))
    Y = np.stack(Ys)
    kw = dict(tol=0.0, iter_cap=5)
    hj = jb.make_hetero(T_act, N_act, 60, 40, dtype=jnp.float64, **kw)
    ht = tb.make_hetero(T_act, N_act, 60, 40, dtype=torch.float64, **kw)
    jout = jb.run_batched_em(jnp.asarray(Y), jb.stack_params(ps, jnp.float64),
                             jem.EMConfig(filter="info"), 5, 0.0,
                             fused_chunk=3, hetero=hj)
    tout = tb.run_batched_em(_t(Y), tb.stack_params(ps),
                             tem.EMConfig(filter="info"), 5, 0.0,
                             fused_chunk=3, hetero=ht)
    for g, w in zip(tout[0], jout[0]):
        close(g.numpy(), np.asarray(w), RTOL)
    for g, w in zip(tout[1], jout[1]):
        assert len(g) == len(w) == 5
        np.testing.assert_allclose(g, w, rtol=RTOL)
    # The N-pad series of lane 2 keep zero loadings and R = 1.
    Lam, R = tout[0].Lam.numpy(), tout[0].R.numpy()
    assert (Lam[2, 36:] == 0.0).all() and (R[2, 36:] == 1.0).all()


@pytest.fixture(scope="module")
def gen_bucket():
    """Three lanes of a (14, 48) capacity bucket at k_max = 40: live
    lengths 10, 14 and 8, scattered missing cells, lane 0's step 4 fully
    masked; lane 1 a k = 20 tenant padded to 40 with inert factors, lane 2
    with eight never-observed N-pad series; the smoother moments of the
    JAX masked filter."""
    rng = np.random.default_rng(1403)
    B, T_, N_ = 3, 14, 48
    t_live = np.array([10, 14, 8])
    Y = rng.standard_normal((B, T_, N_))
    W = (rng.random((B, T_, N_)) < 0.85) * 1.0
    W = W * (np.arange(T_)[None, :, None] < t_live[:, None, None])
    W[0, 4] = 0.0
    W[2, :, 40:] = 0.0
    Y = np.where(W > 0, Y, 0.0)
    ps = [dgp.dfm_params(N_, KS, rng),
          tb.pad_params_to_k(dgp.dfm_params(N_, 20, rng), KS),
          tb.pad_params_to_n(dgp.dfm_params(40, KS, rng), N_)]
    pj = jb.stack_params(ps, dtype=jnp.float64)
    _, (xp, Pp, xf, Pf) = jb.batched_filter_masked(jnp.asarray(Y),
                                                   jnp.asarray(W), pj)
    sm = jb._batched_rts(xp, Pp, xf, Pf, pj.A)
    return dict(Y=Y, W=W, ps=ps, pj=pj, t_new=t_live,
                sm=[np.asarray(a) for a in sm])


def test_masked_serving_twins_at_k40_match_jax(gen_bucket):
    """K2b-m (``_batched_obs_stats_masked``), K4b over a per-step C and
    K1b-m (``_batched_loglik_masked``, through ``batched_filter_masked``),
    K4b-bwd and ``batched_m_step_masked`` (K3b-m, K6b) at k = 40, 1e-10;
    the fully masked step's statistics are exact zeros, the k = 20 lane's
    padded factors stay exactly inert and the N-pad series get exactly
    zero loadings and R at the floor."""
    d = gen_bucket
    Yj, Wj, pj = jnp.asarray(d["Y"]), jnp.asarray(d["W"]), d["pj"]
    Yt, Wt, pt = _t(d["Y"]), _t(d["W"]), tb.stack_params(d["ps"])
    st_j = jb._batched_obs_stats_masked(Yj, Wj, pj.Lam, pj.R)
    st_t = tb._batched_obs_stats_masked(Yt, Wt, pt.Lam, pt.R)
    for g, w in zip(st_t, st_j):
        close(g.numpy(), np.asarray(w), 1e-10)
    b, C, n, ldR = st_t
    assert (b[0, 4] == 0).all() and (C[0, 4] == 0).all()
    assert n[0, 4] == 0 and ldR[0, 4] == 0
    llj, fj = jb.batched_filter_masked(Yj, Wj, pj)
    llt, ft = tb.batched_filter_masked(Yt, Wt, pt)
    for g, w in zip((llt, *ft), (llj, *fj)):
        close(g.numpy(), np.asarray(w), 1e-10)
    smt = tb._batched_rts(*ft, pt.A)
    for g, w in zip(smt, d["sm"]):
        close(g.numpy(), w, 1e-10)
    cfg = dict(estimate_A=True, estimate_Q=True, estimate_init=True)
    t_new = d["t_new"]
    out_j = jb.batched_m_step_masked(
        Yj, Wj, *(jnp.asarray(a) for a in d["sm"]), pj,
        jem.EMConfig(filter="info", **cfg), jnp.asarray(t_new, jnp.int32))
    out_t = tb.batched_m_step_masked(
        Yt, Wt, *(_t(a) for a in d["sm"]), pt,
        tem.EMConfig(filter="info", **cfg),
        torch.tensor(t_new, dtype=torch.int32))
    for g, w in zip(out_t, out_j):
        close(g.numpy(), np.asarray(w), 1e-10)
    Lam, A, R = out_t.Lam.numpy(), out_t.A.numpy(), out_t.R.numpy()
    assert (Lam[1, :, 20:] == 0.0).all()
    assert (A[1, 20:, :] == 0.0).all() and (A[1, :, 20:] == 0.0).all()
    assert (Lam[2, 40:] == 0.0).all()
    assert (R[2, 40:] == tem.EMConfig().r_floor).all()


def test_bsolve_rows_at_k40_matches_jax():
    """K6b's twin at k = 40: per lane chol(sym(S) + jitter), every row
    S^{-1} V_i, on three lanes of moment-like S (a Gram matrix plus a
    ridge, slightly asymmetric) and 50 rows each."""
    rng = np.random.default_rng(1404)
    G = rng.standard_normal((3, 60, KS))
    S = G.transpose(0, 2, 1) @ G / 60 + 0.1 * np.eye(KS)
    S = S + 1e-9 * rng.standard_normal(S.shape)
    V = rng.standard_normal((3, 50, KS))
    want = jb._bsolve_rows(jnp.asarray(S), jnp.asarray(V))
    got = tb._bsolve_rows(_t(S), _t(V))
    close(got.numpy(), np.asarray(want), 1e-10)


def test_k_grid_across_32_matches_jax():
    """``select_n_factors_em(ks=(3, 20, 34))``: the k = 3 and k = 20 lanes
    are padded to k_max = 34 with inert factors, across 32."""
    Y = _panel(60, 40, 6, 1405)
    kw = dict(ks=[3, 20, 34], max_iters=3)
    want = jselect(Y, dtype=np.float64, **kw)
    got = dtt.select_n_factors_em(Y, backend=CPU64, **kw)
    np.testing.assert_array_equal(got.ks, want.ks)
    np.testing.assert_allclose(got.logliks, want.logliks, rtol=RTOL)
    np.testing.assert_allclose(got.ic, want.ic, rtol=RTOL)
    assert got.k_best == want.k_best
    np.testing.assert_array_equal(got.fit.n_iters, want.fit.n_iters)


def test_rolling_windows_at_k33_match_jax():
    """``oos_evaluate(engine="batched")`` at k = 33 with an info seed fit
    (an unmasked panel of N < 512, which ``auto`` would not send to ss
    either): three 50-row windows, horizon 1, the first window's lone fit
    seeding the others."""
    Y = _panel(60, 40, 4, 1406)
    kw = dict(horizon=1, n_windows=3, min_train=50, max_iters=3,
              engine="batched")
    want = joos(JModel(33), Y, backend=JB64, **kw)
    got = dtt.oos_evaluate(dtt.DynamicFactorModel(33), Y, backend=CPU64,
                           **kw)
    np.testing.assert_array_equal(got.origins, want.origins)
    for name in ("errors", "rmse", "rel_rmse"):
        close(getattr(got, name), getattr(want, name), RTOL)
    assert np.isfinite(got.rel_rmse).all()


# --------------------------------------------------------- fleets --

# The lowrank lanes' diffusion-index forecast against the JAX fleet: a
# limit from readings.  It regresses on smoothed factors that a rank-4
# filter leaves nearly collinear, so factors that agree to ~3e-14 give
# forecasts 1.1e-9 apart here; a ridge of 1e-7 instead of 1e-8 moves them
# by 0.42.  Every other output is held to RTOL.
DI_RTOL = 1e-8


@pytest.fixture(scope="module")
def gen_tenants():
    """An 80 x 40 tenant at k = 34 and a 72 x 30 tenant at k = 20 (JAX
    info fits): one bucket at k_max = 34 pads the second across 32."""
    return [_tenant(40, 80, K, 1407), _tenant(30, 72, 20, 1408)]


@pytest.mark.parametrize("flt", ["info", "lowrank"])
def test_fleet_across_32_matches_jax(gen_tenants, flt, tmp_path,
                                     monkeypatch):
    """Two ticks (one tenant sits the second out) of an info fleet and of a
    lowrank bucket at rank 4, against the JAX fleet at test_torch_fleet's
    tolerance (the lowrank diffusion-index forecast at DI_RTOL); the k = 20
    tenant's padded factors stay exactly 0."""
    monkeypatch.setenv("DFM_RUNS", str(tmp_path / "runs"))
    kw = {**FLEET_KW, "capacity": 140, "filter": flt}
    if flt == "lowrank":
        kw["rank"] = 4
    jf = dfm_tpu.open_fleet([t[0] for t in gen_tenants],
                            [t[2] for t in gen_tenants],
                            backend=TPUBackend(dtype=np.float64),
                            robust=False, **kw)
    tf = dtt.open_fleet([t[1] for t in gen_tenants],
                        [t[2] for t in gen_tenants],
                        backend=dtt.TorchBackend(device="cpu",
                                                 dtype=torch.float64), **kw)
    (bucket,) = tf._buckets
    assert bucket.dims == (140, 40, K) and bucket.cfg.filter == flt
    used = [0, 0]
    for tick in ((2, 3), (1, 0)):
        for i, n in enumerate(tick):
            if n:
                rows = gen_tenants[i][3][used[i]:used[i] + n]
                used[i] += n
                tf.submit(f"t{i}", rows)
                jf.submit(f"t{i}", rows)
        to, jo = tf.drain(), jf.drain()
        assert sorted(to) == sorted(jo)
        for name in jo:
            _assert_update_matches(to[name][0], jo[name][0],
                                   DI_RTOL if flt == "lowrank" else RTOL)
    p = bucket.p
    assert (p.Lam[1, :, 20:] == 0.0).all()
    assert (p.A[1, 20:, :] == 0.0).all() and (p.A[1, :, 20:] == 0.0).all()
    assert (p.mu0[1, 20:] == 0.0).all()
    tf.close()
    jf.close()


# -------------------------------------------------------- routing --

@pytest.mark.parametrize("k", [33, 100, 128])
@pytest.mark.parametrize("name", BATCHED)
def test_batched_gen_routes(name, k):
    got = kernels.route(name, k)
    assert got == f"{name}_gen" == kernels.GEN[name]
    # K4b-gen is in the generic K4 pair's own source; the others in their
    # entry point's.
    assert kernels.KERNELS[got][0] == (
        "info_scan_gen.cu" if name in ("batched_info_scan", "batched_rts")
        else kernels.KERNELS[name][0])


def _z(*shape):
    """A tensor with no storage: a wrapper takes its kernel route for any
    device but the CPU, so a "meta" tensor reaches the range check without
    a card."""
    return torch.zeros(shape, device="meta")


# Each wrapper called at k with B = 2, T = 4, N = 8.
WRAPPERS = {
    "batched_info_scan": lambda k: tb._batched_info_scan(
        _z(2, 4, k), _z(2, k, k), _z(2, k, k), _z(2, k, k), _z(2, k),
        _z(2, k, k)),
    "batched_rts": lambda k: tb._batched_rts(
        _z(2, 4, k), _z(2, 4, k, k), _z(2, 4, k), _z(2, 4, k, k),
        _z(2, k, k)),
    "batched_quad": lambda k: tb._batched_quad(
        _z(2, 4, 8), _z(2, 8, k), _z(2, 8), _z(2, 4, k), _z(2, 4, k),
        _z(2, k, k)),
    "batched_quad_masked": lambda k: tb._batched_quad_masked(
        _z(2, 4, 8), _z(2, 4, 8), _z(2, 8, k), _z(2, 8), _z(2, 4, k),
        _z(2, 4, k), _z(2, 4, k, k)),
    "batched_solve_rows": lambda k: tb._bsolve_rows(_z(2, k, k),
                                                    _z(2, 8, k)),
    "batched_obs_stats": lambda k: tb._batched_obs_stats_masked(
        _z(2, 4, 8), _z(2, 4, 8), _z(2, 8, k), _z(2, 8)),
    "batched_mstep_rows": lambda k: tb._batched_mstep_rows(
        _z(2, 4, 8), _z(2, 4, 8), _z(2, 4, k), _z(2, 4, k, k),
        _z(2, 4, k, k), 1e-6),
}


@pytest.mark.parametrize("name", BATCHED)
def test_batched_routes_raise_at_129_before_any_launch(name):
    """k = 129 raises in ``kernels.route`` and in the wrapper, naming the
    ROADMAP row, before any launch (nothing is counted)."""
    with pytest.raises(NotImplementedError, match="Generic k") as err:
        kernels.route(name, kernels.GEN_KMAX + 1)
    assert kernels.GENERIC_K in str(err.value)
    kernels.reset_launches()
    with pytest.raises(NotImplementedError, match="Generic k"):
        WRAPPERS[name](kernels.GEN_KMAX + 1)
    assert not any(kernels.LAUNCHES.values())
