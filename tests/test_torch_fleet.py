"""The port's fleet (dfm_tpu_torch.fleet, serve.batched's fleet core and
the serving twins of estim.batched) against the JAX package at float64 on
the CPU.

Both fleets start from the same fitted tenants (the port's ``FitResult``s
carry the JAX fits' params and standardizers) and take the same queries,
so every output agrees to 1e-9 relative and the iteration counts and
stop states are equal: each tick runs a few warm EM iterations whose
passes differ by ~1e-15.  The JAX fleets run unguarded (``robust=False``),
as the port's do until its guard is ported; without faults the two agree.
Each serving twin matches its JAX function to 1e-10 on one set of inputs,
and K13b's plain twin equals the JAX ring eviction and ragged append bit
for bit (values move, nothing is computed).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu
import dfm_tpu_torch as dtt
from dfm_tpu.api import TPUBackend
from dfm_tpu.estim import batched as jbt
from dfm_tpu.estim.em import EMConfig as JEMConfig
from dfm_tpu.fleet import admission as jadm
from dfm_tpu.sched import buckets as jbuckets
from dfm_tpu.serve.batched import batched_ring_evict
from dfm_tpu.utils import dgp
from dfm_tpu_torch.estim import batched as tbt
from dfm_tpu_torch.estim.em import EMConfig
from dfm_tpu_torch.fleet import admission as tadm
from dfm_tpu_torch.fleet import driver as tdrv
from dfm_tpu_torch.sched import buckets as tbuckets
from dfm_tpu_torch.serve import batched as tsv
from dfm_tpu_torch.utils.data import Standardizer
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-9
JB = TPUBackend(dtype=np.float64, filter="info")
CPU = dtt.TorchBackend(device="cpu", dtype=torch.float64)
KW = dict(capacity=56, max_update_rows=3, max_iters=4, tol=0.0,
          max_classes=1)
_PF = ("Lam", "A", "Q", "R", "mu0", "P0")


def _tenant(N, T, k, seed, extra=10, backend=JB):
    """A JAX fit of a (T, N) masked panel and the port FitResult with its
    params and standardizer, plus the held-out rows."""
    rng = np.random.default_rng(seed)
    Y, _ = dgp.simulate(dgp.dfm_params(N, k, rng), T + extra, rng)
    Y[rng.random(Y.shape) < 0.05] = np.nan
    rj = dfm_tpu.fit(dfm_tpu.DynamicFactorModel(n_factors=k), Y[:T],
                     max_iters=8, backend=backend, telemetry=False)
    s = rj.standardizer
    rt = dtt.FitResult(
        params=rj.params, logliks=rj.logliks, factors=rj.factors,
        factor_cov=rj.factor_cov, converged=rj.converged,
        n_iters=rj.n_iters, standardizer=Standardizer(s.mean, s.scale),
        model=dtt.DynamicFactorModel(k), backend="torch", history=[],
        filter=rj.filter)
    return rj, rt, Y[:T], Y[T:]


@pytest.fixture(scope="module")
def trio():
    """The JAX fleet tests' trio: 10 x 40 and two 12 x 44, k = 2 (one
    bucket that pads T and N)."""
    return [_tenant(10, 40, 2, 21), _tenant(12, 44, 2, 22),
            _tenant(12, 44, 2, 23)]


@pytest.fixture(autouse=True)
def _empty_registry(tmp_path, monkeypatch):
    """Admission calibrates from ``$DFM_RUNS``: an empty registry on both
    sides (the cost model's priors)."""
    monkeypatch.setenv("DFM_RUNS", str(tmp_path / "runs"))


def _open_pair(tens, **kw):
    kw = {**KW, **kw}
    jf = dfm_tpu.open_fleet([t[0] for t in tens], [t[2] for t in tens],
                            backend=JB, robust=False, **kw)
    tf = dtt.open_fleet([t[1] for t in tens], [t[2] for t in tens],
                        backend=CPU, **kw)
    return jf, tf


def _assert_update_matches(tu, ju, di_rtol=RTOL):
    assert (tu.t, tu.n_iters, tu.converged, tu.diverged) == (
        ju.t, ju.n_iters, ju.converged, ju.diverged)
    for name in ("nowcast", "nowcast_sd", "factors", "factor_cov",
                 "forecast_sd", "logliks"):
        close(getattr(tu, name), getattr(ju, name), RTOL)
    for key in ("y", "f"):
        close(tu.forecasts[key], ju.forecasts[key], RTOL)
    close(tu.forecasts["di"], ju.forecasts["di"], di_rtol)
    if ju.coverage is None:
        assert tu.coverage is None
    else:
        assert tu.coverage == pytest.approx(ju.coverage, abs=1e-12)


def _assert_lone(u, ref, tol=1e-9, atol=1e-10, ll_rtol=1e-7):
    """The JAX fleet test's lane-vs-lone-session tolerances
    (tests/test_fleet.py:94-117)."""
    assert u.t == ref.t and u.n_iters == ref.n_iters
    assert u.converged == ref.converged and u.diverged == ref.diverged
    for a, b in ((u.nowcast, ref.nowcast), (u.factors, ref.factors),
                 (u.forecasts["y"], ref.forecasts["y"]),
                 (u.forecasts["f"], ref.forecasts["f"]),
                 (u.forecasts["di"], ref.forecasts["di"])):
        np.testing.assert_allclose(a, b, rtol=tol, atol=atol)
    np.testing.assert_allclose(u.logliks, ref.logliks, rtol=ll_rtol,
                               atol=1e-6)


def _lane(bucket, lane):
    return [x[lane].clone() for x in (bucket.Ybuf, bucket.Wbuf, *bucket.p)]


# ------------------------------------------------------- fleet parity --

# Ticks of (rows per tenant); 0 sits the tick out, None is a pure
# re-forecast query.
TICKS = [(1, 3, 2), (2, 0, 1), (None, 2, 0), (3, 1, 3)]


def test_fleet_matches_jax_and_lone_sessions(trio):
    """Ragged mixed-row ticks, a tick a tenant sits out (its lane bit for
    bit unchanged), a pure re-forecast: every answer is the JAX fleet's
    (1e-9) and each lane is its own lone port session's (the JAX fleet
    test's tolerances)."""
    jf, tf = _open_pair(trio)
    assert tf.n_buckets == 1 and tf.classes == [
        {**c, "rank": 0} for c in jf.classes]
    (bucket,) = tf._buckets
    assert bucket.dims == (56, 12, 2) and bucket.B == 3
    lone = [dtt.open_session(t[1], t[2], backend=CPU,
                             **{k: v for k, v in KW.items()
                                if k != "max_classes"}) for t in trio]
    used = [0, 0, 0]
    for tick in TICKS:
        frozen = {i: _lane(bucket, i) for i, n in enumerate(tick) if n == 0}
        rows = {}
        for i, n in enumerate(tick):
            if n == 0:
                continue
            rows[i] = (None if n is None
                       else trio[i][3][used[i]:used[i] + n])
            used[i] += n or 0
            tf.submit(f"t{i}", rows[i])
            jf.submit(f"t{i}", rows[i])
        to, jo = tf.drain(), jf.drain()
        assert sorted(to) == sorted(jo) == sorted(f"t{i}" for i in rows)
        for i, r in rows.items():
            tu = to[f"t{i}"][0]
            _assert_update_matches(tu, jo[f"t{i}"][0])
            _assert_lone(tu, lone[i].update(r))
        for i, before in frozen.items():
            for a, b in zip(before, _lane(bucket, i)):
                assert torch.equal(a, b), f"frozen lane {i} changed"
    for i, t in enumerate(trio):
        assert tf.tenant_length(f"t{i}") == jf.tenant_length(f"t{i}") \
            == t[2].shape[0] + used[i]
        close(bucket.params_host()[i].Lam,
              jbt.unstack_params(jf._buckets[0].p)[i].Lam, RTOL)
    # The host shadows mirror the device panel.
    for lane in range(bucket.B):
        Yh, Wh = bucket.live_host(lane)
        np.testing.assert_array_equal(Yh, bucket.Ybuf[lane].numpy())
        np.testing.assert_array_equal(Wh, bucket.Wbuf[lane].numpy())
    tf.close()
    with pytest.raises(RuntimeError, match="closed"):
        tf.submit("t0", trio[0][3][:1])


def test_ring_fleet_matches_jax(trio):
    """ring=True with per-tenant capacities below the bucket's (41, 45,
    46): every tick evicts on the device; answers match the JAX ring
    fleet and the host shadows mirror the device panel."""
    jf, tf = _open_pair(trio, capacity=[41, 45, 46], ring=True)
    (bucket,) = tf._buckets
    for tick in ((2, 3, 3), (3, 1, 2), (1, 2, 3)):
        for i, n in enumerate(tick):
            lo = tf._slot_of[f"t{i}"][1].t_total - trio[i][2].shape[0]
            r = trio[i][3][lo:lo + n]
            tf.submit(f"t{i}", r)
            jf.submit(f"t{i}", r)
        to, jo = tf.drain(), jf.drain()
        for name in jo:
            _assert_update_matches(to[name][0], jo[name][0])
    assert [s.n_evicted for s in bucket.slots] == [
        jf._slot_of[f"t{i}"][1].n_evicted for i in range(3)]
    assert min(s.n_evicted for s in bucket.slots) > 0
    for lane in range(bucket.B):
        Yh, Wh = bucket.live_host(lane)
        np.testing.assert_array_equal(Yh, bucket.Ybuf[lane].numpy())
        np.testing.assert_array_equal(Wh, bucket.Wbuf[lane].numpy())
        np.testing.assert_array_equal(
            bucket.Ybuf[lane].numpy(), np.asarray(jf._buckets[0].Ybuf[lane]))


def test_pit_qr_fleet_matches_jax():
    """A pit_qr bucket (the lone masked pit_qr pair once per lane) against
    the JAX pit_qr fleet (the vmapped pair)."""
    pair = [_tenant(8, 24, 2, 43), _tenant(8, 24, 2, 44)]
    jf, tf = _open_pair(pair, capacity=28, filter="pit_qr")
    assert tf.classes[0]["filter"] == jf.classes[0]["filter"] == "pit_qr"
    for tick in ((1, 3), (2, 0)):
        for i, n in enumerate(tick):
            if n:
                tf.submit(f"t{i}", pair[i][3][:n])
                jf.submit(f"t{i}", pair[i][3][:n])
        to, jo = tf.drain(), jf.drain()
        for name in jo:
            _assert_update_matches(to[name][0], jo[name][0])


def test_fault_seam_rolls_back_one_lane_only(trio):
    """The chaos seam: lane 1's loglik drops at iteration 1, so it alone
    diverges and rolls back; its bucket-mates are bit for bit a fault-free
    twin fleet's."""
    outs = []
    for fault in (None, 1):
        fl = dtt.open_fleet([t[1] for t in trio], [t[2] for t in trio],
                            backend=CPU, **KW)
        bk = fl._buckets[0]
        bk.opts = dataclasses.replace(bk.opts, fault_tenant=fault,
                                      fault_iter=1)
        for i, t in enumerate(trio):
            fl.submit(f"t{i}", t[3][:2])
        if fault is None:
            outs.append(fl.drain())
        else:
            with pytest.warns(RuntimeWarning, match="'t1' diverged"):
                outs.append(fl.drain())
    clean, faulted = outs
    u = faulted["t1"][0]
    assert u.diverged and not clean["t1"][0].diverged
    assert u.n_iters == 2 and len(u.logliks) == 2
    for name in ("t0", "t2"):
        a, c = faulted[name][0], clean[name][0]
        for f in ("nowcast", "factors", "factor_cov", "logliks"):
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
        for key in ("y", "f", "di"):
            np.testing.assert_array_equal(a.forecasts[key],
                                          c.forecasts[key])


# ------------------------------------------------ the serving twins --

@pytest.fixture(scope="module")
def twin_inputs():
    """Three lanes of a (16, 9) capacity bucket, k = 3: live lengths 11,
    16 and 9, scattered missing cells, one N-pad series in lane 2; the
    smoother moments from the JAX masked filter at the lanes' params."""
    rng = np.random.default_rng(5)
    B, T, N, k = 3, 16, 9, 3
    t_live = np.array([11, 16, 9])
    Y = rng.standard_normal((B, T, N))
    W = (rng.random((B, T, N)) < 0.85) * 1.0
    W = W * (np.arange(T)[None, :, None] < t_live[:, None, None])
    W[2, :, -1] = 0.0
    Y = np.where(W > 0, Y, 0.0)
    ps = [dgp.dfm_params(N, k, rng) for _ in range(B)]
    pj = jbt.stack_params(ps, dtype=jnp.float64)
    ll, (xp, Pp, xf, Pf) = jbt.batched_filter_masked(
        jnp.asarray(Y), jnp.asarray(W), pj)
    sm = jbt._batched_rts(xp, Pp, xf, Pf, pj.A)
    return dict(Y=Y, W=W, ps=ps, t_new=t_live,
                sm=[np.asarray(a) for a in sm])


def _jt(d):
    return (jnp.asarray(d["Y"]), jnp.asarray(d["W"]),
            jbt.stack_params(d["ps"], dtype=jnp.float64))


def _tt(d):
    return (torch.tensor(d["Y"]), torch.tensor(d["W"]),
            tbt.stack_params(d["ps"]))


def _obs_stats(d):
    (Yj, Wj, pj), (Yt, Wt, pt) = _jt(d), _tt(d)
    return (jbt._batched_obs_stats_masked(Yj, Wj, pj.Lam, pj.R),
            tbt._batched_obs_stats_masked(Yt, Wt, pt.Lam, pt.R))


def _scan_tv(d):
    (Yj, Wj, pj), (_, _, pt) = _jt(d), _tt(d)
    b, C, _, _ = jbt._batched_obs_stats_masked(Yj, Wj, pj.Lam, pj.R)
    tm = lambda a: jnp.moveaxis(a, 1, 0)            # noqa: E731
    outs = jbt._batched_info_scan_tv(tm(b), tm(C), pj.A, pj.Q, pj.mu0,
                                     pj.P0)
    return ([jnp.moveaxis(o, 0, 1) for o in outs],
            tbt._batched_info_scan(torch.tensor(np.asarray(b)),
                                   torch.tensor(np.asarray(C)), pt.A, pt.Q,
                                   pt.mu0, pt.P0))


def _loglik(d):
    (Yj, Wj, pj), (Yt, Wt, pt) = _jt(d), _tt(d)
    stats = jbt._batched_obs_stats_masked(Yj, Wj, pj.Lam, pj.R)
    tm = lambda a: jnp.moveaxis(a, 1, 0)            # noqa: E731
    xp, _, _, Pf, ldG = (jnp.moveaxis(o, 0, 1) for o in
                         jbt._batched_info_scan_tv(tm(stats[0]),
                                                   tm(stats[1]), pj.A, pj.Q,
                                                   pj.mu0, pj.P0))
    tst = [torch.tensor(np.asarray(a)) for a in stats]
    targs = [torch.tensor(np.asarray(a)) for a in (xp, Pf, ldG)]
    return (jbt._batched_loglik_masked(Yj, Wj, pj, *stats, xp, Pf, ldG),
            tbt._batched_loglik_masked(Yt, Wt, pt, *tst, *targs))


def _filter(d):
    (Yj, Wj, pj), (Yt, Wt, pt) = _jt(d), _tt(d)
    llj, mj = jbt.batched_filter_masked(Yj, Wj, pj)
    llt, mt = tbt.batched_filter_masked(Yt, Wt, pt)
    return (llj, *mj), (llt, *mt)


def _m_step(d):
    (Yj, Wj, pj), (Yt, Wt, pt) = _jt(d), _tt(d)
    cfg = dict(estimate_A=True, estimate_Q=True, estimate_init=True)
    out_j = jbt.batched_m_step_masked(
        Yj, Wj, *(jnp.asarray(a) for a in d["sm"]), pj,
        JEMConfig(filter="info", **cfg), jnp.asarray(d["t_new"], jnp.int32))
    out_t = tbt.batched_m_step_masked(
        Yt, Wt, *(torch.tensor(a) for a in d["sm"]), pt,
        EMConfig(filter="info", **cfg),
        torch.tensor(d["t_new"], dtype=torch.int32))
    return out_j, out_t


TWINS = {"obs_stats_masked": _obs_stats, "info_scan_tv": _scan_tv,
         "loglik_masked": _loglik, "filter_masked": _filter,
         "m_step_masked": _m_step}


@pytest.mark.parametrize("twin", list(TWINS))
def test_serving_twin_matches_jax(twin_inputs, twin):
    want, got = TWINS[twin](twin_inputs)
    for w, g in zip(want, got):
        close(g.numpy(), np.asarray(w), 1e-10)


def test_m_step_never_observed_series_is_inert(twin_inputs):
    """The N-pad series of lane 2 (never observed) gets an exactly zero
    loading row, and R = r_floor, from the masked M-step rows (K3b-m's
    plain twin)."""
    Y, W = (torch.tensor(twin_inputs[k]) for k in ("Y", "W"))
    x_sm, P_sm = (torch.tensor(a) for a in twin_inputs["sm"][:2])
    Lam, R = tbt._batched_mstep_rows_plain(Y, W, x_sm,
                                           P_sm + tbt._outer(x_sm), P_sm,
                                           1e-6)
    assert torch.equal(Lam[2, -1], torch.zeros(3, dtype=torch.float64))
    assert float(R[2, -1]) == 1e-6


# ---------------------------------------------------------- K13b twin --

# Per lane (t_cur, n_evict, n_new) on a (12, 7) buffer with a 4-row
# budget: a plain append, a ring eviction, a partial one, a drop past
# capacity, a frozen lane, a free lane at t_cur = T_cap.
K13B_LANES = [(8, 0, 3), (12, 3, 3), (11, 2, 3), (10, 0, 4), (7, 0, 0),
              (12, 0, 0)]


@pytest.mark.parametrize("n_pad", [0, 2], ids=["exact N", "N-pad"])
def test_batched_ring_append_twin_is_bit_exact_with_jax(n_pad):
    rng = np.random.default_rng(7 + n_pad)
    B, Tc, N, r = len(K13B_LANES), 12, 7, 4
    n_real = N - n_pad
    Y = np.zeros((B, Tc, N))
    W = np.zeros((B, Tc, N))
    rows = np.zeros((B, r, N))
    rmask = np.zeros((B, r, N))
    for b, (t_cur, _, n_new) in enumerate(K13B_LANES):
        Y[b, :t_cur, :n_real] = rng.standard_normal((t_cur, n_real))
        W[b, :t_cur, :n_real] = rng.random((t_cur, n_real)) < 0.8
        rows[b, :n_new, :n_real] = rng.standard_normal((n_new, n_real))
        rmask[b, :n_new, :n_real] = 1.0
    t_cur, n_evict, n_new = (np.array(c, np.int32)
                             for c in zip(*K13B_LANES))
    Yj, Wj = batched_ring_evict(jnp.asarray(Y), jnp.asarray(W),
                                jnp.asarray(n_evict), jnp.asarray(t_cur))
    Yj, Wj = jbt.batched_ragged_append(Yj, Wj, jnp.asarray(rows),
                                       jnp.asarray(rmask),
                                       jnp.asarray(t_cur - n_evict))
    Yt, Wt = torch.tensor(Y), torch.tensor(W)
    tsv.batched_ring_evict_append(Yt, Wt, torch.tensor(rows),
                                  torch.tensor(rmask),
                                  torch.tensor(n_evict),
                                  torch.tensor(t_cur))
    np.testing.assert_array_equal(Yt.numpy(), np.asarray(Yj))
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    t_new = t_cur - n_evict + n_new
    for b in range(B):
        assert not Yt[b, t_new[b]:].any() and not Wt[b, t_new[b]:].any()
    assert not Yt[..., n_real:].any() and not Wt[..., n_real:].any()
    for b in (4, 5):            # frozen and free lanes: bit for bit
        np.testing.assert_array_equal(Yt[b].numpy(), Y[b])
        np.testing.assert_array_equal(Wt[b].numpy(), W[b])


def test_batched_ring_append_rejects_bad_counts():
    Y = torch.zeros((1, 6, 3))
    rows = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="n_evict <= t_cur"):
        tsv.batched_ring_evict_append(Y, Y.clone(), rows, rows,
                                      torch.tensor([3]), torch.tensor([2]))


# ------------------------------------------- admission and planning --

SHAPES = [(60, 10, 2), (60, 10, 2), (80, 14, 2), (80, 14, 3)]


@pytest.mark.parametrize("max_classes", [1, 2, 3])
def test_plan_admission_matches_jax(max_classes):
    iters = [4, 4, 5, 3]
    keys = [(True, True, False, "info", 0)] * 3 + [
        (True, True, False, "pit_qr", 0)]
    for k in (None, keys):
        if k is not None and max_classes < 2:
            with pytest.raises(ValueError, match="max_classes"):
                tadm.plan_admission(SHAPES, iters, k,
                                    max_classes=max_classes)
            continue
        t = tadm.plan_admission(SHAPES, iters, k, max_classes=max_classes)
        j = jadm.plan_admission(SHAPES, iters, k, max_classes=max_classes)
        assert [(c.dims, c.members) for c in t] == [
            (c.dims, c.members) for c in j]
        assert tadm.fleet_pad_waste(SHAPES, iters, t) == pytest.approx(
            jadm.fleet_pad_waste(SHAPES, iters, j), abs=0)
    t = tbuckets.plan_capacity_classes(SHAPES, [5] * 4,
                                       max_classes=max_classes)
    j = jbuckets.plan_capacity_classes(SHAPES, [5] * 4,
                                       max_classes=max_classes)
    assert [(b.dims, b.jobs, b.cap) for b in t.buckets] == [
        (b.dims, b.jobs, b.cap) for b in j.buckets]
    assert (t.bucket_of, t.pad_waste_frac, t.predicted_wall_s) == (
        j.bucket_of, j.pad_waste_frac, j.predicted_wall_s)


def test_choose_engine_and_residency_match_jax():
    dims = (56, 12, 2)
    assert tadm.choose_engine(dims, 4) == jadm.choose_engine(dims, 4) \
        == "info"
    classes = tadm.plan_admission(SHAPES, [4] * 4, max_classes=2)
    jcl = jadm.plan_admission(SHAPES, [4] * 4, max_classes=2)
    for resident in (None, 2, 3):
        assert tadm.plan_residency(classes, resident, r_max=3) == \
            jadm.plan_residency(jcl, resident, r_max=3)
    assert tadm.readmission_cost_s(dims, r_max=3) == \
        jadm.readmission_cost_s(dims, r_max=3)

    class _M:       # the evidence gate: an unprofiled engine is no pick
        pit_qr_calibrated = False
        lowrank_calibrated = False

        def iter_s(self, N, T, k, filt="seq"):
            return {"seq": 1.0, "pit_qr": 0.2, "lowrank": 0.1}[filt]

    m = _M()
    assert tadm.choose_engine(dims, 4, model=m) == "info"
    m.pit_qr_calibrated = True
    assert tadm.choose_engine(dims, 4, model=m) == "pit_qr"


def test_auto_filter_on_an_empty_registry_is_info(trio):
    fl = dtt.open_fleet([t[1] for t in trio], [t[2] for t in trio],
                        backend=CPU, filter="auto", **KW)
    assert [c["filter"] for c in fl.classes] == ["info"]


def _profiles(path, device):
    """A registry of two calibrated profiles of one device at the trio's
    bucket shape: the sequential scan at 10 ms an iteration and the rank-r
    engine at 1 ms, so its evidence makes "auto" pick lowrank."""
    path.mkdir(parents=True, exist_ok=True)
    recs = [{"run_id": f"{device}-{prof}", "kind": "profile",
             "config": {"device": device, "N": 12, "T": 56, "k": 2,
                        "profile": prof, "iters": 4},
             "metrics": {"dispatch_ms_per_program": 80.0,
                         "sustained_ms_per_iter": ms}}
            for prof, ms in (("chunked", 10.0), ("lowrank", 1.0))]
    (path / "runs.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    return str(path)


def test_cost_model_is_the_backends_own_device(trio, tmp_path, monkeypatch):
    """A registry holding only TPU profiles no longer plans a fleet on
    another device: on the CPU, admission and "auto" price with the "cpu"
    prior (uncalibrated) and route info, though the TPU evidence alone
    would pick lowrank."""
    runs = _profiles(tmp_path / "tpu_runs", "tpu")
    monkeypatch.setenv("DFM_RUNS", runs)
    tpu = tadm._load_model(runs, None)
    assert (tpu.device, tpu.calibrated, tpu.lowrank_calibrated) == (
        "tpu", True, True)
    assert tadm.choose_engine((56, 12, 2), 4, runs=runs) == "lowrank"
    seen = []
    real = tadm.fit_cost_model

    def spy(profiles, device=None):
        m = real(profiles, device=device)
        seen.append(m)
        return m

    monkeypatch.setattr(tadm, "fit_cost_model", spy)
    fl = dtt.open_fleet([t[1] for t in trio], [t[2] for t in trio],
                        backend=CPU, filter="auto", **KW)
    assert [c["filter"] for c in fl.classes] == ["info"]
    assert seen and all(m.device == "cpu" and not m.calibrated
                        for m in seen)
    assert tadm.device_class(torch.device("cuda")) == "gpu"
    assert tadm.device_class(CPU.device) == "cpu"


def test_auto_routes_lowrank_on_own_device_evidence(trio, tmp_path,
                                                    monkeypatch):
    """With calibrated "cpu" profiles that favour the rank-r engine, an
    "auto" CPU fleet routes its class to lowrank (it raised before the
    engine was ported) and answers as an explicit lowrank fleet."""
    monkeypatch.setenv("DFM_RUNS", _profiles(tmp_path / "cpu_runs", "cpu"))
    fa = dtt.open_fleet([t[1] for t in trio], [t[2] for t in trio],
                        backend=CPU, filter="auto", **KW)
    fe = dtt.open_fleet([t[1] for t in trio], [t[2] for t in trio],
                        backend=CPU, filter="lowrank", **KW)
    assert [c["filter"] for c in fa.classes] == ["lowrank"]
    assert fa.classes == fe.classes
    for fl in (fa, fe):
        for i in range(3):
            fl.submit(f"t{i}", trio[i][3][:2])
    oa, oe = fa.drain(), fe.drain()
    for name in oe:
        np.testing.assert_array_equal(oa[name][0].nowcast,
                                      oe[name][0].nowcast)
        np.testing.assert_array_equal(oa[name][0].factors,
                                      oe[name][0].factors)


# ------------------------------------------------------ host guards --

def test_open_fleet_validation(trio):
    _, res, Y0, _ = trio[0]
    with pytest.raises(ValueError, match="at least one"):
        dtt.open_fleet([], [])
    with pytest.raises(ValueError, match="panels"):
        dtt.open_fleet([res], [], backend=CPU)
    with pytest.raises(TypeError, match="FitResult"):
        dtt.open_fleet(["nope"], [Y0], backend=CPU)
    with pytest.raises(ValueError, match="UNIQUE"):
        dtt.open_fleet([res, res], [Y0, Y0], tenants=["a", "a"],
                       backend=CPU)
    with pytest.raises(ValueError, match="TorchBackend"):
        dtt.open_fleet([res], [Y0], backend="cpu")
    with pytest.raises(ValueError, match="capacity"):
        dtt.open_fleet([res], [Y0], capacity=10, backend=CPU)
    with pytest.raises(ValueError, match="N=10"):
        dtt.open_fleet([res], [Y0[:, :4]], backend=CPU)
    with pytest.raises(ValueError, match="one value per"):
        dtt.open_fleet([res], [Y0], max_iters=[3, 4], backend=CPU)
    with pytest.raises(ValueError, match="unknown fleet filter"):
        dtt.open_fleet([res], [Y0], filter="dense", backend=CPU)
    with pytest.raises(ValueError, match="ring mode"):
        dtt.open_fleet([res], [Y0], capacity=42, max_update_rows=50,
                       ring=True, backend=CPU)


def test_submit_validation_touches_nothing(trio):
    fl = dtt.open_fleet([t[1] for t in trio], [t[2] for t in trio],
                        backend=CPU, **{**KW, "capacity": [43, 56, 56]})
    stream = trio[0][3]
    bucket = fl._buckets[0]
    Yb = bucket.Ybuf.clone()
    with pytest.raises(KeyError, match="unknown tenant"):
        fl.submit("nope", stream[:1])
    with pytest.raises(ValueError, match="max_update_rows"):
        fl.submit("t0", stream[:4])
    with pytest.raises(ValueError, match="rows must be"):
        fl.submit("t0", np.zeros((1, 3)))
    with pytest.raises(ValueError, match="mask requires rows"):
        fl.submit("t0", None, mask=np.ones((1, 10)))
    assert fl.submit("t0", stream[:2]) == 1       # 40 -> 42 queued
    with pytest.raises(ValueError, match="capacity overflow"):
        fl.submit("t0", stream[2:4])              # projected 44 > 43
    assert fl.pending == 1 and torch.equal(bucket.Ybuf, Yb)
    assert fl.drain()["t0"][0].t == 42 and fl.pending == 0
    assert "SessionFleet" in repr(fl)
    fl.close()
    assert "closed" in repr(fl)


def test_swap_params_rewrites_one_lane(trio):
    fl = dtt.open_fleet([t[1] for t in trio], [t[2] for t in trio],
                        backend=CPU, **KW)
    bucket = fl._buckets[0]
    before = bucket.params_host()
    fl.swap_params("t1", trio[1][1].params)          # bit-equal: a no-op
    for f in _PF:
        for a, b in zip(before, bucket.params_host()):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    p = trio[1][1].params
    fl.swap_params("t1", dataclasses.replace(p, R=2.0 * np.asarray(p.R)))
    after = bucket.params_host()
    np.testing.assert_array_equal(after[1].R[:12], 2.0 * before[1].R[:12])
    for lane in (0, 2):
        np.testing.assert_array_equal(after[lane].R, before[lane].R)
    with pytest.raises(ValueError, match="serves"):
        fl.swap_params("t0", p)


def _unported(fl, trio):
    res, Y0 = trio[0][1], trio[0][2]
    return {
        "robust": lambda: dtt.open_fleet([res], [Y0], backend=CPU,
                                         robust=True),
        "resident": lambda: dtt.open_fleet([res], [Y0], backend=CPU,
                                           resident=1),
        "sharded": lambda: dtt.open_fleet([res], [Y0], backend="sharded"),
        "trace": lambda: fl.submit("t0", Y0[:1], trace={}),
        "accounting": fl.accounting,
        "evict": lambda: fl.evict("t0"),
        "admit": lambda: fl.admit("t0"),
        "snapshot_all": lambda: fl.snapshot_all("snap"),
        "restore_fleet": lambda: tdrv.restore_fleet("snap"),
        "read_manifest": lambda: tdrv.read_manifest("snap"),
        "fleet_impl_sharded": tsv.fleet_impl_sharded,
    }


UNPORTED = ["robust", "resident", "sharded", "trace",
            "accounting", "evict", "admit", "snapshot_all", "restore_fleet",
            "read_manifest", "fleet_impl_sharded"]


@pytest.mark.parametrize("what", UNPORTED)
def test_unported_fleet_parts_raise(trio, what):
    fl = dtt.open_fleet([t[1] for t in trio[:1]], [t[2] for t in trio[:1]],
                        backend=CPU, **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        _unported(fl, trio)[what]()
