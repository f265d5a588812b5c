"""The port's streaming sessions (dfm_tpu_torch.serve) and kernel K13's
plain twin against the JAX package at float64 on the CPU.

Both sessions start from the same fitted params and panel (the port's
``FitResult`` is built from the JAX fit's fields) and take the same
updates, so every output agrees to 1e-9 relative: each query runs a few
warm EM iterations whose passes differ by ~1e-15.  K13 moves values and
does no arithmetic: its plain twin equals the JAX roll-select-scatter bit
for bit.  The JAX sessions run unguarded (``robust=False``), as the
port's do until its guard is ported; without faults the two agree.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu import open_session as jopen
from dfm_tpu.api import DynamicFactorModel as JModel
from dfm_tpu.api import TPUBackend
from dfm_tpu.api import fit as jfit
from dfm_tpu.serve.batched import ring_evict
from dfm_tpu.utils import dgp
from dfm_tpu_torch.serve.batched import ring_evict_append_plain
from dfm_tpu_torch.serve.session import NowcastSession
from dfm_tpu_torch.utils.data import Standardizer
from torch_parity import close, one_torch_thread  # noqa: F401

RTOL = 1e-9
UPDATES = [(40, 43), (43, 44), (44, 48), None, (48, 51)]   # None: re-forecast


@pytest.fixture(scope="module")
def panel():
    """(60, 40) panel with scattered missing values and a ragged edge."""
    rng = np.random.default_rng(9)
    p = dgp.dfm_params(40, 2, rng)
    Y, _ = dgp.simulate(p, 60, rng)
    Y = 2.0 * Y + 1.0
    Y[rng.random(Y.shape) < 0.08] = np.nan
    Y[55:, :10] = np.nan
    return Y


@pytest.fixture(scope="module")
def fits(panel):
    """JAX fused fits of the first 40 rows by (engine, standardize), each
    with the port FitResult carrying the same params and standardizer."""
    cache = {}

    def get(flt, standardize):
        key = (flt, standardize)
        if key not in cache:
            Y0 = panel[:40, :12] if flt == "dense" else panel[:40]
            jb = TPUBackend(dtype=np.float64, filter=flt, fused_chunk=4)
            rj = jfit(JModel(2, standardize=standardize), Y0, backend=jb,
                      fused=True, max_iters=8, tol=0.0, robust=False)
            s = rj.standardizer
            rt = dtt.FitResult(
                params=rj.params, logliks=rj.logliks, factors=rj.factors,
                factor_cov=rj.factor_cov, converged=rj.converged,
                n_iters=rj.n_iters,
                standardizer=(Standardizer(s.mean, s.scale) if s is not None
                              else None),
                model=dtt.DynamicFactorModel(2, standardize=standardize),
                backend="torch", history=[], filter=rj.filter)
            cache[key] = (rj, rt, jb)
        return cache[key]

    return get


def _tb(flt="auto", chunk=4):
    return dtt.TorchBackend(device="cpu", dtype=torch.float64, filter=flt,
                            fused_chunk=chunk)


def _assert_update_matches(tu, ju, coverage=True):
    assert (tu.t, tu.n_iters, tu.converged, tu.diverged) == (
        ju.t, ju.n_iters, ju.converged, ju.diverged)
    for name in ("nowcast", "nowcast_sd", "factors", "factor_cov",
                 "forecast_sd", "logliks"):
        close(getattr(tu, name), getattr(ju, name), RTOL)
    for key in ("y", "f", "di"):
        close(tu.forecasts[key], ju.forecasts[key], RTOL)
    if not coverage:
        return
    if ju.coverage is None:
        assert tu.coverage is None
    else:
        assert tu.coverage == pytest.approx(ju.coverage, abs=1e-12)


# ------------------------------------------------------------ K13 twin --

# (t_cur, n_evict, n_new) on a 12-row buffer with a 4-row budget.
K13_CASES = {"pass-through": (8, 0, 3), "evict": (12, 3, 3),
             "partial": (11, 2, 3), "drop past capacity": (10, 0, 4),
             "no new rows": (7, 0, 0), "evict all of budget": (12, 4, 4)}


@pytest.mark.parametrize("case", list(K13_CASES))
def test_ring_append_twin_is_bit_exact_with_jax(case):
    t_cur, n_evict, n_new = K13_CASES[case]
    rng = np.random.default_rng(len(case))
    Tc, N, r = 12, 5, 4
    Y = np.zeros((Tc, N))
    Y[:t_cur] = rng.standard_normal((t_cur, N))
    W = (rng.random((Tc, N)) < 0.8) * (np.arange(Tc) < t_cur)[:, None] * 1.0
    rows = np.zeros((r, N))
    rows[:n_new] = rng.standard_normal((n_new, N))
    rmask = np.zeros((r, N))
    rmask[:n_new] = 1.0
    Yj, Wj = ring_evict(jnp.asarray(Y), jnp.asarray(W), jnp.int32(n_evict),
                        jnp.int32(t_cur))
    idx = t_cur - n_evict + jnp.arange(r)
    Yj = Yj.at[idx].set(jnp.asarray(rows), mode="drop")
    Wj = Wj.at[idx].set(jnp.asarray(rmask), mode="drop")
    Yt, Wt = torch.tensor(Y), torch.tensor(W)
    ring_evict_append_plain(Yt, Wt, torch.tensor(rows), torch.tensor(rmask),
                            n_evict, t_cur)
    np.testing.assert_array_equal(Yt.numpy(), np.asarray(Yj))
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    if n_evict == 0:   # the live rows pass through untouched
        np.testing.assert_array_equal(Yt.numpy()[:t_cur], Y[:t_cur])


# ------------------------------------------------------ session parity --

# (engine, standardize, ring): ring sessions open at capacity 42, so the
# first update overflows partly (t = 40 + 3 > 42) and the next ones fully.
SESSIONS = [("dense", True, False), ("info", False, False),
            ("info", True, False), ("pit_qr", True, False),
            ("dense", False, True), ("info", False, True),
            ("pit_qr", False, True)]


@pytest.mark.parametrize("flt,standardize,ring", SESSIONS,
                         ids=["-".join(map(str, s)) for s in SESSIONS])
def test_session_matches_jax(panel, fits, flt, standardize, ring):
    rj, rt, jb = fits(flt, standardize)
    Y = panel[:, :12] if flt == "dense" else panel
    kw = dict(capacity=42 if ring else 60, max_update_rows=4, max_iters=5,
              tol=0.0, ring=ring)
    js = jopen(rj, Y[:40], backend=jb, robust=False, **kw)
    ts = dtt.open_session(rt, Y[:40], backend=_tb(flt), **kw)
    assert ts.filter == js.filter == flt
    for sl in UPDATES:
        rows = None if sl is None else Y[sl[0]:sl[1]]
        _assert_update_matches(ts.update(rows), js.update(rows))
    assert (ts.t, ts.n_evicted, ts.remaining) == (js.t, js.n_evicted,
                                                  js.remaining)
    # Hot-swap both sessions to the fit's params and keep streaming.
    ts.swap_params(rt.params)
    js.swap_params(rj.params)
    _assert_update_matches(ts.update(Y[51:53]), js.update(Y[51:53]))
    for f in ("Lam", "A", "Q", "R"):
        close(getattr(ts.params(), f), getattr(js.params(), f), RTOL)


def test_host_guards_raise_before_device_work(panel, fits):
    _, rt, _ = fits("info", False)
    s = dtt.open_session(rt, panel[:40], backend=_tb(), capacity=42,
                         max_update_rows=3)
    buf = s._Ybuf.clone()
    with pytest.raises(ValueError, match="ring=True"):
        s.update(panel[40:43])                     # 40 + 3 > 42
    with pytest.raises(ValueError, match="max_update_rows=3"):
        s.update(panel[40:44])
    with pytest.raises(ValueError, match="new_rows must be"):
        s.update(panel[40:41, :5])
    with pytest.raises(ValueError, match="empty"):
        s.update(panel[40:40])
    with pytest.raises(ValueError, match="mask requires new_rows"):
        s.update(None, mask=np.ones((1, 40)))
    assert s.t == 40 and s._n_queries == 0
    assert torch.equal(s._Ybuf, buf)
    with pytest.raises(ValueError, match="capacity"):
        dtt.open_session(rt, panel[:40], backend=_tb(), capacity=30)
    with pytest.raises(ValueError, match="N=40"):
        dtt.open_session(rt, panel[:40, :5], backend=_tb())
    with pytest.raises(TypeError, match="FitResult"):
        dtt.open_session("nope", panel[:40], backend=_tb())


@pytest.mark.parametrize("kw", [dict(robust=True)], ids=["robust"])
def test_unported_options_raise(panel, fits, kw):
    _, rt, _ = fits("info", False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dtt.open_session(rt, panel[:40], backend=_tb(), **kw)


def test_lowrank_session_snapshot_carries_engine_and_rank(panel, fits,
                                                          tmp_path):
    """A lowrank session at rank 1 answers as the JAX one (same shape key,
    ``rank{r}`` suffix included); its snapshot stores the engine and the
    rank, and restores as a rank-1 lowrank session in both packages."""
    rj, rt, jb = fits("info", False)
    kw = dict(capacity=60, max_update_rows=4, max_iters=3, tol=0.0,
              filter="lowrank", rank=1)
    ts = dtt.open_session(rt, panel[:40], backend=_tb(), **kw)
    js = jopen(rj, panel[:40], backend=jb, robust=False, **kw)
    assert (ts.filter, ts.rank) == (js.filter, js.rank) == ("lowrank", 1)
    assert ts.key == js._key and "/rank1/" in ts.key
    _assert_update_matches(ts.update(panel[40:43]), js.update(panel[40:43]))
    path = ts.snapshot(str(tmp_path / "lowrank.npz"))
    tr = dtt.open_session(snapshot=path, backend=_tb())
    jr = jopen(snapshot=path, backend=jb, robust=False)
    assert (tr.filter, tr.rank) == (jr.filter, jr.rank) == ("lowrank", 1)
    _assert_update_matches(tr.update(panel[43:45]), jr.update(panel[43:45]))


def test_unported_query_hooks_raise(panel, fits):
    _, rt, _ = fits("info", False)
    with pytest.raises(NotImplementedError, match="item 3"):
        dtt.fit(rt.model, panel[:40], backend=_tb(), warm_start=rt)
    s = dtt.open_session(rt, panel[:40], backend=_tb())
    with pytest.raises(NotImplementedError, match="item 13"):
        s.update(panel[40:41], trace={"id": "x"})
    with pytest.raises(NotImplementedError, match="item 13"):
        s.accounting()


def test_diverged_update_keeps_last_good_params(panel, fits):
    rj, rt, jb = fits("info", False)
    kw = dict(capacity=60, max_update_rows=2, max_iters=8, tol=0.0)
    js = jopen(rj, panel[:40], backend=jb, robust=False, **kw)
    ts = dtt.open_session(rt, panel[:40], backend=_tb(), **kw)
    for s in (js, ts):
        s._opts = dataclasses.replace(s._opts, fault_chunk=1)
    with pytest.warns(RuntimeWarning, match="diverged"):
        tu = ts.update(panel[40:41])
    with pytest.warns(RuntimeWarning, match="diverged"):
        ju = js.update(panel[40:41])
    assert tu.diverged and not tu.converged and tu.n_iters == ju.n_iters
    _assert_update_matches(tu, ju)
    for f in ("Lam", "A", "Q", "R"):
        close(getattr(ts.params(), f), getattr(js.params(), f), RTOL)
    # The session survives: clear the fault and keep streaming.
    for s in (js, ts):
        s._opts = dataclasses.replace(s._opts, fault_chunk=None)
    tu2, ju2 = ts.update(panel[41:42]), js.update(panel[41:42])
    assert tu2.t == 42 and not tu2.diverged
    _assert_update_matches(tu2, ju2)


@pytest.mark.parametrize("ring", [False, True], ids=["append", "ring"])
def test_failed_query_restores_the_device_panel(panel, fits, monkeypatch,
                                                ring):
    """A query that raises after K13 edited the panel in place leaves the
    session as it was: the device panel comes back from the host shadows,
    and the next query equals a twin's that never failed."""
    import dfm_tpu_torch.serve.session as ses
    _, rt, _ = fits("info", False)
    kw = dict(capacity=40 if ring else 50, max_update_rows=3, max_iters=3,
              tol=0.0, ring=ring)
    s = dtt.open_session(rt, panel[:40], backend=_tb(), **kw)
    twin = dtt.open_session(rt, panel[:40], backend=_tb(), **kw)
    s.update(panel[40:43])
    twin.update(panel[40:43])
    t = s.t
    Yb, Wb = s._Ybuf.clone(), s._Wbuf.clone()

    def fail(*a, **k):
        raise RuntimeError("injected after K13")

    with monkeypatch.context() as m:
        m.setattr(ses, "em_while", fail)
        with pytest.raises(RuntimeError, match="injected"):
            s.update(panel[43:46])
    assert (s.t, s.total_rows, s._n_queries) == (t, 43, 1)
    assert torch.equal(s._Ybuf, Yb) and torch.equal(s._Wbuf, Wb)
    u, v = s.update(panel[43:46]), twin.update(panel[43:46])
    assert u.t == v.t == (40 if ring else 46)
    for name in ("nowcast", "factors", "logliks"):
        np.testing.assert_array_equal(getattr(u, name), getattr(v, name))
    assert torch.equal(s._Ybuf, twin._Ybuf)


def test_snapshots_cross_between_the_packages(panel, fits, tmp_path):
    rj, rt, jb = fits("info", True)
    kw = dict(capacity=50, max_update_rows=4, max_iters=4, tol=0.0,
              ring=True)
    js = jopen(rj, panel[:40], backend=jb, robust=False, **kw)
    js.update(panel[40:44])
    js.update(panel[44:48])
    path = str(tmp_path / "jax.npz")
    js.snapshot(path)
    ts = dtt.open_session(snapshot=path, backend=_tb())
    assert (ts.t, ts.total_rows, ts.capacity, ts.ring) == (48, 48, 50, True)
    # A restored session has no previous band: no coverage on its first
    # query, while the JAX session streamed on.
    tu = ts.update(panel[48:51])
    assert tu.coverage is None
    _assert_update_matches(tu, js.update(panel[48:51]), coverage=False)
    # The port's snapshot, restored into a smaller ring by both packages.
    path2 = str(tmp_path / "port.npz")
    ts.snapshot(path2)
    ts2 = dtt.open_session(snapshot=path2, backend=_tb(), capacity=44)
    js2 = jopen(snapshot=path2, backend=jb, robust=False, capacity=44)
    assert ts2.t == js2.t == 44 and ts2.n_evicted == js2.n_evicted == 7
    _assert_update_matches(ts2.update(panel[51:53]), js2.update(panel[51:53]))
    with pytest.raises(ValueError, match="ring"):
        dtt.open_session(snapshot=path2, backend=_tb(), capacity=44,
                         ring=False)


def test_one_read_per_query(panel, fits, monkeypatch):
    _, rt, _ = fits("info", False)
    reads = []
    orig = NowcastSession._read
    monkeypatch.setattr(NowcastSession, "_read",
                        lambda self, out: reads.append(1) or orig(self, out))
    s = dtt.open_session(rt, panel[:40], backend=_tb(), max_iters=2)
    for i in range(4):
        s.update(panel[40 + i])
    s.update(None)
    assert len(reads) == 5


def test_fit_keep_session(panel):
    Y0 = panel[:40]
    res = dtt.fit(dtt.DynamicFactorModel(2), Y0, backend=_tb(), fused=True,
                  max_iters=6, tol=0.0,
                  keep_session=dict(capacity=50, max_update_rows=2))
    s = res.session
    assert isinstance(s, NowcastSession) and s.t == 40 and s.capacity == 50
    assert s.filter == res.filter == "info"
    u = s.update(panel[40:42])
    assert u.t == 42 and u.nowcast.shape == (40,)
    assert np.isfinite(u.nowcast).all()
    assert dtt.fit(dtt.DynamicFactorModel(2), Y0, backend=_tb(),
                   max_iters=2).session is None
