"""The port's batched multi-fit engine (dfm_tpu_torch.estim.batched)
against the JAX package's at float64 on the CPU.

Both sides get the same inputs, made with numpy from one seed.  The
modules (the small linalg, the stats, the scans, the loglik, the M-step,
the state machine and its chunked driver on a 20-iteration Hetero
bucket) agree to 1e-10 relative: the port runs each kernel's plain twin,
which rounds in another order than the JAX forms (~1e-15 a pass).
Whole fits through ``fit_many``: logliks 1e-9, params 1e-7, the same
iteration counts, convergence flags and update counts, as
tests/test_batched.py asks of the JAX engine against lone fits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.estim import batched as jb
from dfm_tpu.estim import em as jem
from dfm_tpu.estim import init as jinit
from dfm_tpu.utils import dgp
from dfm_tpu_torch.backends import cpu_ref as tcpu
from dfm_tpu_torch.estim import batched as tb
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.estim import init as tinit
from dfm_tpu_torch.utils.data import standardize
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-10
FIELDS = ("Lam", "A", "Q", "R", "mu0", "P0")
CPU64 = dtt.TorchBackend(device="cpu", dtype=torch.float64)
B, T, N, K = 3, 40, 12, 2
T_ACT, N_ACT = (40, 30, 25), (12, 9, 12)
HYPERS = dict(q_scale=[1.0, 0.8, 1.2], r_scale=[1.0, 1.1, 0.9],
              lam_ridge=[0.0, 0.5, 0.2])


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _n(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def _close_all(got, want, rtol=RTOL):
    for g, w in zip(got, want):
        close(_n(g), np.asarray(w), rtol)


def _panels(Bn, Tn, Nn, k, seed, noises=None):
    """Bn independent factor panels with per-problem noise scales."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(Bn):
        F = rng.standard_normal((Tn, k))
        Lam = rng.standard_normal((Nn, k))
        nz = 0.5 if noises is None else noises[b]
        out.append(F @ Lam.T + nz * rng.standard_normal((Tn, Nn)))
    return np.stack(out)


@pytest.fixture(scope="module")
def lanes():
    """B lanes of a mixed-shape bucket: panels padded to (T, N) with zero
    pad steps and pad series, params padded with inert series; both
    sides' params and Hetero bundles (with and without the hypers)."""
    rng = np.random.default_rng(0)
    Ys, ps = [], []
    for t, n in zip(T_ACT, N_ACT):
        p = dgp.dfm_params(n, K, rng)
        Y, _ = dgp.simulate(p, t, rng)
        Ys.append(tb.pad_panel_to_n(tb.pad_panel_to_t(Y, T), N))
        ps.append(tb.pad_params_to_n(p, N))
    Y = np.stack(Ys)
    het = {}
    for name, hy in (("plain", {}), ("hypers", HYPERS)):
        kw = dict(tol=[1e-4, 0.0, 1e-6], iter_cap=[9, 12, 5], **hy)
        het[name] = (jb.make_hetero(T_ACT, N_ACT, T, N, dtype=jnp.float64,
                                    **kw),
                     tb.make_hetero(T_ACT, N_ACT, T, N, dtype=torch.float64,
                                    **kw))
    return dict(Y=Y, ps=ps, pj=jb.stack_params(ps, jnp.float64),
                pt=tb.stack_params(ps), het=het)


def _het(lanes, which):
    if which is None:
        return None, None
    return lanes["het"][which]


@pytest.mark.parametrize("k", [2, 3, 10])
def test_small_linalg_matches_jax(k):
    rng = np.random.default_rng(k)
    M = rng.standard_normal((4, k, k + 2))
    S = M @ M.transpose(0, 2, 1)
    V = rng.standard_normal((4, 7, k))
    Rhs = rng.standard_normal((4, k, 3))
    close(tb.bchol(_t(S)).numpy(), jb.bchol(jnp.asarray(S)), RTOL)
    L = np.asarray(jb.bchol(jnp.asarray(S)))
    close(tb.bchol_solve(_t(L), _t(Rhs)).numpy(),
          jb.bchol_solve(jnp.asarray(L), jnp.asarray(Rhs)), RTOL)
    close(tb._bsolve_rows(_t(S), _t(V)).numpy(),
          jb._bsolve_rows(jnp.asarray(S), jnp.asarray(V)), RTOL)


def test_param_and_panel_padding_match_jax(lanes):
    p = lanes["ps"][1]
    for fn, arg in (("pad_params_to_k", 5), ("slice_params_to_k", 1),
                    ("pad_params_to_n", 15), ("slice_params_to_n", 9)):
        got, want = getattr(tb, fn)(p, arg), getattr(jb, fn)(p, arg)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    Y = lanes["Y"][2]
    for fn, arg in (("pad_panel_to_n", 20), ("pad_panel_to_t", 44)):
        np.testing.assert_array_equal(getattr(tb, fn)(Y, arg),
                                      getattr(jb, fn)(Y, arg))
    back = tb.unstack_params(lanes["pt"])
    for got, want in zip(back, jb.unstack_params(lanes["pj"])):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError):
        tb.pad_params_to_k(p, 1)


@pytest.mark.parametrize("which", ["plain", "hypers"])
def test_make_hetero_matches_jax(lanes, which):
    hj, ht = lanes["het"][which]
    for name in jb.Hetero._fields:
        a, b = getattr(ht, name), getattr(hj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    assert ht.iter_cap.dtype == torch.int32
    with pytest.raises(ValueError):
        tb.make_hetero([0], [3], T, N, dtype=torch.float64, tol=0.0,
                       iter_cap=3)


def test_obs_stats_matches_jax(lanes):
    Y, pj, pt = lanes["Y"], lanes["pj"], lanes["pt"]
    _close_all(tb._batched_obs_stats(_t(Y), pt.Lam, pt.R),
               jb._batched_obs_stats(jnp.asarray(Y), pj.Lam, pj.R))


@pytest.fixture(scope="module")
def jax_filters(lanes):
    """The JAX batched filter and smoother, without and with the Hetero
    bundle (time-major scans as the JAX module runs them)."""
    Y, pj = jnp.asarray(lanes["Y"]), lanes["pj"]
    out = {}
    for which in (None, "plain"):
        hj = _het(lanes, which)[0]
        ll, flt = jb._batched_filter(Y, pj, hj)
        sm = jb._batched_rts(*flt, pj.A)
        b, C, _ = jb._batched_obs_stats(Y, pj.Lam, pj.R)
        t_seq = None if hj is None else jnp.moveaxis(hj.t_mask, 1, 0)
        scan = jb._batched_info_scan(jnp.moveaxis(b, 1, 0), C, pj.A, pj.Q,
                                     pj.mu0, pj.P0, t_seq=t_seq)
        out[which] = dict(ll=np.asarray(ll),
                          flt=[np.asarray(x) for x in flt],
                          sm=[np.asarray(x) for x in sm],
                          scan=[np.moveaxis(np.asarray(x), 0, 1)
                                for x in scan])
    return out


@pytest.mark.parametrize("which", [None, "plain"])
def test_info_scan_matches_jax(lanes, jax_filters, which):
    """K4b-fwd's twin (batch-major) against the JAX time-major scan, with
    the t_seq freeze: at a lane's pad steps the carry holds."""
    pt = lanes["pt"]
    ht = _het(lanes, which)[1]
    b, C, _ = tb._batched_obs_stats(_t(lanes["Y"]), pt.Lam, pt.R)
    got = tb._batched_info_scan(b, C, pt.A, pt.Q, pt.mu0, pt.P0,
                                None if ht is None else ht.t_mask)
    _close_all(got, jax_filters[which]["scan"])
    if ht is not None:                        # frozen past t_act = 25
        xp, Pp, xf, Pf = (x.numpy() for x in got[:4])
        for x in (xp, xf):
            np.testing.assert_array_equal(x[2, 25:], x[2, 25:26].repeat(15, 0))
        np.testing.assert_array_equal(Pf[2, 25:], Pp[2, 25:])


def test_info_scan_freeze_ignores_pad_junk(lanes):
    """Non-finite data at pad steps never reaches the frozen moments."""
    pt = lanes["pt"]
    ht = lanes["het"]["plain"][1]
    b, C, _ = tb._batched_obs_stats(_t(lanes["Y"]), pt.Lam, pt.R)
    clean = tb._batched_info_scan(b, C, pt.A, pt.Q, pt.mu0, pt.P0,
                                  ht.t_mask)
    b = b.clone()
    b[2, 30] = float("nan")
    b[1, 35] = float("inf")
    dirty = tb._batched_info_scan(b, C, pt.A, pt.Q, pt.mu0, pt.P0,
                                  ht.t_mask)
    for c, d in zip(clean[:4], dirty[:4]):
        assert torch.equal(c, d)


@pytest.mark.parametrize("which", [None, "plain"])
def test_filter_loglik_and_rts_match_jax(lanes, jax_filters, which):
    ht = _het(lanes, which)[1]
    ll, flt = tb._batched_filter(_t(lanes["Y"]), lanes["pt"], ht)
    want = jax_filters[which]
    close(ll.numpy(), want["ll"], RTOL)
    _close_all(flt, want["flt"])
    _close_all(tb._batched_rts(*flt, lanes["pt"].A), want["sm"])
    mask = lanes["het"]["plain"][1].t_mask
    close(tb._mask_t(_t(want["sm"][1]), mask).numpy(),
          jb._mask_t(jnp.asarray(want["sm"][1]),
                     lanes["het"]["plain"][0].t_mask), 0.0)


def test_quad_twin_matches_jax_residual_pass(lanes, jax_filters):
    """K1b's twin: quad_R and U as the JAX loglik forms them."""
    Y, pt = _t(lanes["Y"]), lanes["pt"]
    b, C, _ = tb._batched_obs_stats(Y, pt.Lam, pt.R)
    xp = _t(jax_filters[None]["flt"][0])
    q, U = tb._batched_quad(Y, pt.Lam, pt.R, xp, b, C)
    Lam = np.stack([p.Lam for p in lanes["ps"]])
    R = np.stack([p.R for p in lanes["ps"]])
    V = lanes["Y"] - np.einsum("btk,bnk->btn", xp.numpy(), Lam)
    close(q.numpy(), (V * (V / R[:, None, :])).sum(-1), RTOL)
    close(U.numpy(), b.numpy() - np.einsum("bkl,btl->btk", C.numpy(),
                                           xp.numpy()), RTOL)


# (hetero bundle, estimate_A, estimate_Q, estimate_init)
MSTEPS = [(None, True, True, False), (None, False, True, True),
          (None, False, False, False), ("plain", True, True, False),
          ("hypers", True, True, True), ("hypers", False, True, False)]


@pytest.mark.parametrize("which,eA,eQ,eI", MSTEPS)
def test_m_step_matches_jax(lanes, jax_filters, which, eA, eQ, eI):
    hj, ht = _het(lanes, which)
    sm = jax_filters[None if which is None else "plain"]["sm"]
    Y = lanes["Y"]
    Ysq = np.einsum("btn,btn->bn", Y, Y)
    kw = dict(estimate_A=eA, estimate_Q=eQ, estimate_init=eI, filter="info")
    want = jb.batched_m_step(jnp.asarray(Y), *(jnp.asarray(x) for x in sm),
                             lanes["pj"], jem.EMConfig(**kw),
                             jnp.asarray(Ysq), hetero=hj)
    got = tb.batched_m_step(_t(Y), *(_t(x) for x in sm), lanes["pt"],
                            tem.EMConfig(**kw), _t(Ysq), hetero=ht)
    _close_all(got, want)
    if which is not None:                     # pad series stay inert
        assert float(got.Lam[1, 9:].abs().max()) == 0.0
        assert torch.equal(got.R[1, 9:], torch.ones(3, dtype=torch.float64))


def _carry(lanes, side):
    import jax.numpy as xp
    if side == "jax":
        p = lanes["pj"]
        return (p, p, xp.zeros(B), xp.zeros(B, xp.int32),
                xp.zeros(B, xp.int32))
    p = lanes["pt"]
    z = torch.zeros(B, dtype=torch.float64)
    zi = torch.zeros(B, dtype=torch.int32)
    return (p, p, z, zi, zi)


@pytest.mark.parametrize("which", [None, "hypers"])
def test_em_chunk_core_matches_jax(lanes, which):
    """Six iterations of the state machine with the metrics record: the
    carry (params, roll-back target, loglik, state, trace length), the
    logliks and the metrics."""
    hj, ht = _het(lanes, which)
    cfg = dict(filter="info")
    Y = lanes["Y"]
    jc, (jll, jmet) = jb._em_chunk_core(
        jnp.asarray(Y), _carry(lanes, "jax"), jnp.float64(1e-5),
        jnp.float64(1e-3), jem.EMConfig(**cfg), 6, with_metrics=True,
        hetero=hj)
    tc, tll, tmet = tb._em_chunk_core(
        _t(Y), _carry(lanes, "torch"), torch.tensor(1e-5, dtype=torch.float64),
        torch.tensor(1e-3, dtype=torch.float64), tem.EMConfig(**cfg), 6,
        with_metrics=True, hetero=ht)
    for g, w in zip(tc[:2], jc[:2]):
        _close_all(g, w)
    close(tc[2].numpy(), jc[2], RTOL)
    for g, w in zip(tc[3:], jc[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(tll.numpy(), jll, rtol=RTOL)
    np.testing.assert_allclose(tmet.numpy(), jmet, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("which", [None, "plain"])
def test_smooth_core_matches_jax(lanes, which):
    hj, ht = _het(lanes, which)
    _close_all(tb._smooth_core(_t(lanes["Y"]), lanes["pt"], ht),
               jb._smooth_core(jnp.asarray(lanes["Y"]), lanes["pj"], hj))


@pytest.mark.parametrize("which", ["plain", "hypers"])
def test_run_batched_em_hetero_matches_jax(lanes, which):
    """The chunked driver in mixed-shape mode: per-lane tol, noise floor
    and iteration cap (9, 12, 5), the hypers' plateau rule."""
    hj, ht = lanes["het"][which]
    cfg = dict(filter="info")
    Y = lanes["Y"]
    jout = jb.run_batched_em(jnp.asarray(Y), lanes["pj"],
                             jem.EMConfig(**cfg), 20, 0.0, fused_chunk=4,
                             hetero=hj)
    tout = tb.run_batched_em(_t(Y), lanes["pt"], tem.EMConfig(**cfg), 20,
                             0.0, fused_chunk=4, hetero=ht)
    _close_all(tout[0], jout[0])
    for g, w in zip(tout[1], jout[1]):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, rtol=RTOL)
    np.testing.assert_array_equal(tout[2], jout[2])
    np.testing.assert_array_equal(tout[3], jout[3])
    assert all(len(t) <= c for t, c in zip(tout[1], (9, 12, 5)))
    assert len(tout[1][1]) == 12              # tol 0: runs to its cap
    for hg, hw in zip(tout[4], jout[4]):
        assert hg.n_chunks == hw.n_chunks
        assert hg.monotonicity_violations == hw.monotonicity_violations


def _fit_pair(spec_args, model_k, max_iters, tol, **kw):
    Y = spec_args
    rj = jb.fit_many(jb.DFMBatchSpec(Y=Y, model=JModel(model_k)),
                     max_iters=max_iters, tol=tol, dtype=np.float64,
                     robust=False, **kw)
    rt = dtt.fit_many(dtt.DFMBatchSpec(Y=Y, model=dtt.DynamicFactorModel(
        model_k)), backend=CPU64, max_iters=max_iters, tol=tol, **kw)
    return rt, rj


def _assert_batch_matches(rt, rj):
    np.testing.assert_array_equal(rt.n_iters, rj.n_iters)
    np.testing.assert_array_equal(rt.converged, rj.converged)
    np.testing.assert_array_equal(rt.p_iters, rj.p_iters)
    for b in range(len(rt.logliks)):
        np.testing.assert_allclose(rt.logliks[b], rj.logliks[b], rtol=1e-9)
        for f in FIELDS:
            close(getattr(rt.params[b], f), getattr(rj.params[b], f), 1e-7)
        close(rt.factors[b], rj.factors[b], 1e-7)
        close(rt.factor_cov[b], rj.factor_cov[b], 1e-7)
        assert rt.health[b].ok == rj.health[b].ok
        assert rt.health[b].n_chunks == rj.health[b].n_chunks


def test_fit_many_staggered_matches_jax():
    """tests/test_batched.py:66's case: lanes converging at different
    iterations inside a 7-iteration chunk freeze without perturbing the
    others; with the metrics record."""
    Y = _panels(4, 80, 15, 2, seed=1, noises=[0.05, 0.5, 2.0, 5.0])
    rt, rj = _fit_pair(Y, 2, 100, 1e-5, fused_chunk=7, with_metrics=True)
    _assert_batch_matches(rt, rj)
    assert len(set(rt.n_iters.tolist())) > 1
    np.testing.assert_allclose(rt.metrics, rj.metrics, rtol=1e-9, atol=1e-9)
    chunks = -(-int(rt.n_iters.max()) // 7)
    assert rt.host_reads == chunks + 1
    assert rt.best() == rj.best()


def test_fit_many_fixed_budget_and_device_init_match_jax():
    Y = _panels(3, 60, 12, 2, seed=0)
    rt, rj = _fit_pair(Y, 2, 10, 0.0, fused_chunk=4)
    _assert_batch_matches(rt, rj)
    assert rt.host_reads == 3 + 1
    # The batched device init: the lone device init of each lane, and the
    # JAX batched init up to the sign of each factor column.
    Yz = np.stack([standardize(y)[0] for y in Y])
    got = tinit.pca_init_batched(_t(Yz), 2)
    want = jinit.pca_init_batched(Yz, 2, dtype=jnp.float64)
    for b in range(3):
        lone = tinit.pca_init_device(_t(Yz[b]), 2)
        for f in FIELDS:
            close(getattr(got[b], f), getattr(lone, f), 1e-12)
        sgn = np.sign(got[b].Lam[0] * want[b].Lam[0])
        close(got[b].Lam * sgn, want[b].Lam, 1e-9)
        close(got[b].R, want[b].R, 1e-9)
        close(got[b].A * np.outer(sgn, sgn), want[b].A, 1e-9)
    res = dtt.fit_many(dtt.DFMBatchSpec(Y=Y, model=dtt.DynamicFactorModel(2)),
                       backend=CPU64, max_iters=3, tol=0.0, device_init=True)
    assert all(np.isfinite(t).all() and len(t) == 3 for t in res.logliks)
    assert res.host_reads == 1 + 1 + 1    # the init, one chunk, the final


def test_k_grid_lane_matches_lone_port_fit():
    rng = np.random.default_rng(4)
    F = rng.standard_normal((70, 3))
    Y = F @ rng.standard_normal((3, 14)) + 0.4 * rng.standard_normal((70, 14))
    res = dtt.fit_many(dtt.DFMBatchSpec.k_grid(Y, ks=[1, 3]), backend=CPU64,
                       max_iters=12, tol=0.0)
    for b, k in enumerate([1, 3]):
        lone = dtt.fit(dtt.DynamicFactorModel(k), Y,
                       backend=dtt.TorchBackend(device="cpu",
                                                dtype=torch.float64,
                                                filter="info"),
                       max_iters=12, tol=0.0)
        np.testing.assert_allclose(res.logliks[b], lone.logliks, rtol=1e-9)
        assert res.params[b].Lam.shape == (14, k)
        for f in FIELDS:
            close(getattr(res.params[b], f), getattr(lone.params, f), 1e-7)
        close(res.factors[b], lone.factors, 1e-7)


def test_restart_zero_matches_plain_port_fit():
    rng = np.random.default_rng(5)
    F = rng.standard_normal((60, 2))
    Y = F @ rng.standard_normal((2, 12)) + 0.5 * rng.standard_normal((60, 12))
    model = dtt.DynamicFactorModel(2)
    spec = dtt.DFMBatchSpec.restarts(model, Y, 4, seed=1)
    jspec = jb.DFMBatchSpec.restarts(JModel(2), Y, 4, seed=1)
    for a, b in zip(spec.inits, jspec.inits):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    res = dtt.fit_many(spec, backend=CPU64, max_iters=10, tol=0.0)
    lone = dtt.fit(model, Y, backend=dtt.TorchBackend(
        device="cpu", dtype=torch.float64, filter="info"), max_iters=10,
        tol=0.0)
    np.testing.assert_allclose(res.logliks[0], lone.logliks, rtol=1e-9)
    for f in FIELDS:
        close(getattr(res.params[0], f), getattr(lone.params, f), 1e-7)
    assert res.best() == int(np.argmax(res.logliks_final))


def test_nan_lane_leaves_the_others_untouched():
    """A lane whose init is NaN runs its whole budget with NaN logliks
    (NaN -> continue); the other lanes equal the batch without it."""
    Y = _panels(3, 50, 10, 2, seed=8)
    cfg = tem.EMConfig(filter="info")
    Yz = np.stack([standardize(y)[0] for y in Y])
    inits = [tcpu.pca_init(y, 2) for y in Yz]
    Yz = _t(Yz)
    bad = inits[1].copy()
    bad.R[3] = np.nan
    full = tb.run_batched_em(Yz, tb.stack_params([inits[0], bad, inits[2]]),
                             cfg, 12, 1e-6, fused_chunk=5)
    ref = tb.run_batched_em(Yz[[0, 2]], tb.stack_params([inits[0], inits[2]]),
                            cfg, 12, 1e-6, fused_chunk=5)
    assert len(full[1][1]) == 12 and np.isnan(full[1][1]).all()
    assert not full[2][1] and not full[4][1].ok
    for i, j in ((0, 0), (2, 1)):
        np.testing.assert_allclose(full[1][i], ref[1][j], rtol=1e-12)
        assert full[2][i] == ref[2][j] and full[3][i] == ref[3][j]
        for g, w in zip(full[0], ref[0]):
            assert torch.isfinite(g[i]).all()
            close(g[i].numpy(), w[j].numpy(), 1e-12)


def test_unported_options_raise():
    spec = dtt.DFMBatchSpec(Y=_panels(2, 30, 8, 1, seed=9),
                            model=dtt.DynamicFactorModel(1))
    for kw, item in ((dict(backend="sharded"), "item 12"),
                     (dict(backend=CPU64, n_devices=2), "item 12"),
                     (dict(backend=CPU64, pipeline=2), "item 4")):
        with pytest.raises(NotImplementedError, match=item):
            dtt.fit_many(spec, max_iters=2, **kw)
    with pytest.raises(ValueError):
        dtt.fit_many(spec, backend="tpu", max_iters=2)
