"""The batched paths at 16 < k <= 32, where the card takes the wide twins
of K4b, K1b, K6b, K2b-m, K1b-m and K3b-m, against dfm_tpu at float64 on
the CPU.

The CPU runs each kernel's plain twin, which takes any k, so these tests
hold the batched paths' algebra at k = 20 (k = 18 for the rolling
windows) against the JAX package: ``fit_many`` restarts, a Hetero
``run_batched_em`` (one lane ragged in T, one in N), the masked serving
twins on a bucket whose k = 12 lane is padded past 16 and whose N-pad
series is never observed, the k-grid with a lane padded across 16, the
rolling windows, an info fleet of a k = 20 and a k = 12 tenant and a
lowrank fleet bucket at k = 20.  The EM paths agree to 1e-9 relative
(each iteration carries ~1e-13 rounding into the next params), single
passes to 1e-10.  ``kernels.route`` sends the seven batched entry points
to today's kernel for k <= 16, to the ``_wide`` kernel (same source) for
17..32 and to the ``_gen`` kernel past that (tests/test_torch_batched_gen.py).
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
from test_torch_fleet import KW as FLEET_KW
from test_torch_fleet import _assert_update_matches, _tenant
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-9
K = 20
FIELDS = ("Lam", "A", "Q", "R", "mu0", "P0")
CPU64 = dtt.TorchBackend(device="cpu", dtype=torch.float64, filter="info")
JB64 = TPUBackend(dtype=np.float64, filter="info")
BATCHED = ("batched_info_scan", "batched_rts", "batched_quad",
           "batched_quad_masked", "batched_solve_rows", "batched_obs_stats",
           "batched_mstep_rows")


def _panel(T_, N_, k, seed, scale=1.5):
    rng = np.random.default_rng(seed)
    Y, _ = dgp.simulate(dgp.dfm_params(N_, k, rng), T_, rng)
    return scale * Y + 0.5


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _assert_batch_matches(rt, rj):
    np.testing.assert_array_equal(rt.n_iters, rj.n_iters)
    np.testing.assert_array_equal(rt.converged, rj.converged)
    for b in range(len(rt.logliks)):
        np.testing.assert_allclose(rt.logliks[b], rj.logliks[b], rtol=RTOL)
        for f in FIELDS:
            close(getattr(rt.params[b], f), getattr(rj.params[b], f), RTOL)
        close(rt.factors[b], rj.factors[b], RTOL)
        close(rt.factor_cov[b], rj.factor_cov[b], RTOL)


# ---------------------------------------------------- batched fits --

def test_fit_many_restarts_at_k20_matches_jax():
    """Three restarts of one 60 x 30 panel at k = 20 (the port's jittered
    inits on both sides), 4 iterations, tol = 0."""
    Y = _panel(60, 30, K, 2001)
    spec = dtt.DFMBatchSpec.restarts(dtt.DynamicFactorModel(K), Y, 3)
    rj = jb.fit_many(jb.DFMBatchSpec(Y=spec.Y, model=JModel(K),
                                     inits=spec.inits),
                     max_iters=4, tol=0.0, dtype=np.float64, robust=False)
    rt = dtt.fit_many(spec, backend=CPU64, max_iters=4, tol=0.0)
    _assert_batch_matches(rt, rj)
    assert all(len(t) == 4 for t in rt.logliks)


def test_run_batched_em_hetero_at_k20_matches_jax():
    """A Hetero bucket at k = 20: lane 1 ragged in T (45 of 60 steps),
    lane 2 in N (24 of 30 series), each from its own PCA init; 6
    iterations in chunks of 4."""
    Z = standardize(_panel(60, 30, K, 2002))[0]
    T_act, N_act = (60, 45, 60), (30, 30, 24)
    Ys, ps = [], []
    for t, n in zip(T_act, N_act):
        Ys.append(tb.pad_panel_to_n(tb.pad_panel_to_t(Z[:t, :n], 60), 30))
        ps.append(tb.pad_params_to_n(tcpu.pca_init(Z[:t, :n], K), 30))
    Y = np.stack(Ys)
    kw = dict(tol=0.0, iter_cap=6)
    hj = jb.make_hetero(T_act, N_act, 60, 30, dtype=jnp.float64, **kw)
    ht = tb.make_hetero(T_act, N_act, 60, 30, dtype=torch.float64, **kw)
    jout = jb.run_batched_em(jnp.asarray(Y), jb.stack_params(ps, jnp.float64),
                             jem.EMConfig(filter="info"), 6, 0.0,
                             fused_chunk=4, hetero=hj)
    tout = tb.run_batched_em(_t(Y), tb.stack_params(ps),
                             tem.EMConfig(filter="info"), 6, 0.0,
                             fused_chunk=4, hetero=ht)
    for g, w in zip(tout[0], jout[0]):
        close(g.numpy(), np.asarray(w), RTOL)
    for g, w in zip(tout[1], jout[1]):
        assert len(g) == len(w) == 6
        np.testing.assert_allclose(g, w, rtol=RTOL)
    # The N-pad series of lane 2 keep zero loadings and R = 1.
    Lam, R = tout[0].Lam.numpy(), tout[0].R.numpy()
    assert (Lam[2, 24:] == 0.0).all() and (R[2, 24:] == 1.0).all()


@pytest.fixture(scope="module")
def wide_bucket():
    """Three lanes of a (16, 26) capacity bucket at k_max = 20: live
    lengths 11, 16 and 9, scattered missing cells; lane 1 a k = 12 tenant
    padded to 20 with inert factors, lane 2 with six never-observed N-pad
    series; the smoother moments of the JAX masked filter."""
    rng = np.random.default_rng(2003)
    B, T_, N_ = 3, 16, 26
    t_live = np.array([11, 16, 9])
    Y = rng.standard_normal((B, T_, N_))
    W = (rng.random((B, T_, N_)) < 0.85) * 1.0
    W = W * (np.arange(T_)[None, :, None] < t_live[:, None, None])
    W[2, :, 20:] = 0.0
    Y = np.where(W > 0, Y, 0.0)
    ps = [dgp.dfm_params(N_, K, rng),
          tb.pad_params_to_k(dgp.dfm_params(N_, 12, rng), K),
          tb.pad_params_to_n(dgp.dfm_params(20, K, rng), N_)]
    pj = jb.stack_params(ps, dtype=jnp.float64)
    _, (xp, Pp, xf, Pf) = jb.batched_filter_masked(jnp.asarray(Y),
                                                   jnp.asarray(W), pj)
    sm = jb._batched_rts(xp, Pp, xf, Pf, pj.A)
    return dict(Y=Y, W=W, ps=ps, pj=pj, t_new=t_live,
                sm=[np.asarray(a) for a in sm])


def test_masked_serving_twins_at_k20_match_jax(wide_bucket):
    """K2b-m, K4b over a per-step C and K1b-m (``batched_filter_masked``),
    K4b-bwd and the masked M-step (K3b-m, K6b) at k = 20, 1e-10; the
    k = 12 lane's padded factors stay exactly inert and the N-pad series
    get exactly zero loadings and R at the floor."""
    d = wide_bucket
    Yj, Wj, pj = jnp.asarray(d["Y"]), jnp.asarray(d["W"]), d["pj"]
    Yt, Wt, pt = _t(d["Y"]), _t(d["W"]), tb.stack_params(d["ps"])
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
    assert (Lam[1, :, 12:] == 0.0).all()
    assert (A[1, 12:, :] == 0.0).all() and (A[1, :, 12:] == 0.0).all()
    assert (Lam[2, 20:] == 0.0).all()
    assert (R[2, 20:] == tem.EMConfig().r_floor).all()


def test_k_grid_across_16_matches_jax():
    """``select_n_factors_em(ks=(3, 17, 20))``: the k = 3 lane is padded
    to k_max = 20 with inert factors, across 16."""
    Y = _panel(60, 30, 6, 2004)
    kw = dict(ks=[3, 17, 20], max_iters=4)
    want = jselect(Y, dtype=np.float64, **kw)
    got = dtt.select_n_factors_em(Y, backend=CPU64, **kw)
    np.testing.assert_array_equal(got.ks, want.ks)
    np.testing.assert_allclose(got.logliks, want.logliks, rtol=RTOL)
    np.testing.assert_allclose(got.ic, want.ic, rtol=RTOL)
    assert got.k_best == want.k_best
    np.testing.assert_array_equal(got.fit.n_iters, want.fit.n_iters)


def test_rolling_windows_at_k18_match_jax():
    """``oos_evaluate(engine="batched")`` at k = 18: three 50-row windows,
    horizon 1, the first window's lone fit seeding the others."""
    Y = _panel(60, 24, 4, 2005)
    kw = dict(horizon=1, n_windows=3, min_train=50, max_iters=4,
              engine="batched")
    want = joos(JModel(18), Y, backend=JB64, **kw)
    got = dtt.oos_evaluate(dtt.DynamicFactorModel(18), Y, backend=CPU64,
                           **kw)
    np.testing.assert_array_equal(got.origins, want.origins)
    for name in ("errors", "rmse", "rel_rmse"):
        close(getattr(got, name), getattr(want, name), 1e-7)
    assert np.isfinite(got.rel_rmse).all()


# --------------------------------------------------------- fleets --

@pytest.fixture(scope="module")
def wide_tenants():
    """An 80 x 30 tenant at k = 20 and a 72 x 24 tenant at k = 12 (JAX
    info fits): one bucket at k_max = 20 pads the second across 16.  (The
    least-conditioned output is the lowrank k = 20 lane's diffusion-index
    forecast, a regression on 20 smoothed factors that a rank-4 filter
    leaves nearly collinear: ~5e-10 from the JAX fleet at these lengths,
    ~2e-9 at 40 rows.)"""
    return [_tenant(30, 80, K, 2006), _tenant(24, 72, 12, 2007)]


@pytest.mark.parametrize("flt", ["info", "lowrank"])
def test_fleet_across_16_matches_jax(wide_tenants, flt, tmp_path,
                                     monkeypatch):
    """Three ticks (one tenant sits one out) of an info fleet and of a
    lowrank bucket at rank 4, against the JAX fleet at test_torch_fleet's
    tolerance."""
    monkeypatch.setenv("DFM_RUNS", str(tmp_path / "runs"))
    kw = {**FLEET_KW, "capacity": 100, "filter": flt}
    if flt == "lowrank":
        kw["rank"] = 4
    jf = dfm_tpu.open_fleet([t[0] for t in wide_tenants],
                            [t[2] for t in wide_tenants],
                            backend=TPUBackend(dtype=np.float64),
                            robust=False, **kw)
    tf = dtt.open_fleet([t[1] for t in wide_tenants],
                        [t[2] for t in wide_tenants],
                        backend=dtt.TorchBackend(device="cpu",
                                                 dtype=torch.float64), **kw)
    (bucket,) = tf._buckets
    assert bucket.dims == (100, 30, K) and bucket.cfg.filter == flt
    used = [0, 0]
    for tick in ((2, 3), (1, 0), (3, 2)):
        for i, n in enumerate(tick):
            if n:
                rows = wide_tenants[i][3][used[i]:used[i] + n]
                used[i] += n
                tf.submit(f"t{i}", rows)
                jf.submit(f"t{i}", rows)
        to, jo = tf.drain(), jf.drain()
        assert sorted(to) == sorted(jo)
        for name in jo:
            _assert_update_matches(to[name][0], jo[name][0])
    # The k = 12 tenant's padded factors stay exactly inert.
    assert (bucket.p.Lam[1, :, 12:] == 0.0).all()
    tf.close()
    jf.close()


# -------------------------------------------------------- routing --

@pytest.mark.parametrize("k", [16, 17, 32])
@pytest.mark.parametrize("name", BATCHED)
def test_batched_routes(name, k):
    got = kernels.route(name, k)
    assert got == (name if k <= kernels.KMAX else f"{name}_wide")
    assert kernels.KERNELS[got][0] == kernels.KERNELS[name][0]
    assert kernels.KERNELS[got][1] == kernels.KERNELS[name][1]


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
def test_batched_routes_raise_at_33_naming_the_roadmap_row(name):
    """The wide tier ends at 32: k = 33 routes to the generic kernel (same
    source), and the range's end moved to 129, which raises in
    ``kernels.route`` and in the wrapper, naming the ROADMAP row, before
    any launch (nothing is counted)."""
    assert kernels.route(name, kernels.WIDE_KMAX) == f"{name}_wide"
    assert kernels.route(name, kernels.WIDE_KMAX + 1) == f"{name}_gen"
    with pytest.raises(NotImplementedError, match="Generic k") as err:
        kernels.route(name, kernels.GEN_KMAX + 1)
    assert kernels.GENERIC_K in str(err.value)
    kernels.reset_launches()
    with pytest.raises(NotImplementedError, match="Generic k"):
        WRAPPERS[name](kernels.GEN_KMAX + 1)
    assert not any(kernels.LAUNCHES.values())
