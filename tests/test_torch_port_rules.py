"""Rules of the PyTorch port, checked on its source and on a CUDA-less CPU.

- No file of ``dfm_tpu_torch/`` and not ``chip_smoke.py`` imports JAX or
  anything of ``dfm_tpu`` (the port keeps its own copies).
- No ``time.time()``: wall clocks are ``time.perf_counter`` around work
  that ends in a device sync or a blocking read.
- Every fit driver, and the fleet tick, runs inside
  ``highest_precision()`` (no TF32 in f32 matrix products: ~1e-4
  relative loglik against the 1e-5 contract).
- On a machine without CUDA the default backend raises instead of running
  on the CPU, and the CPU path launches no kernel.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import dfm_tpu_torch as dtt
from dfm_tpu_torch import kernels
from dfm_tpu_torch.ssm import parallel_filter as tpf
from dfm_tpu_torch.ssm.params import SSMParams as TP
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dfm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# (module file, function) pairs that drive a fit or a contract evaluation.
FIT_DRIVERS = [("dfm_tpu_torch/api.py", "fit"),
               ("dfm_tpu_torch/estim/em.py", "run_em_chunked"),
               ("dfm_tpu_torch/estim/em.py", "fit_em_chunked"),
               ("dfm_tpu_torch/estim/fused.py", "run_fused"),
               ("dfm_tpu_torch/serve/session.py", "update"),
               ("dfm_tpu_torch/ssm/info_filter.py", "loglik_eval"),
               ("dfm_tpu_torch/estim/batched.py", "fit_many"),
               ("dfm_tpu_torch/estim/batched.py", "run_batched_em"),
               ("dfm_tpu_torch/estim/select.py", "select_n_factors_em"),
               ("dfm_tpu_torch/estim/evaluate.py", "oos_evaluate"),
               ("dfm_tpu_torch/fleet/driver.py", "_tick"),
               ("dfm_tpu_torch/models/tv_loadings.py", "tvl_fit"),
               ("dfm_tpu_torch/models/tv_loadings.py", "tvl_loglik_eval"),
               ("dfm_tpu_torch/models/mixed_freq.py", "mf_fit"),
               ("dfm_tpu_torch/models/mixed_freq.py", "mf_loglik_eval"),
               ("dfm_tpu_torch/models/sv.py", "sv_fit"),
               ("dfm_tpu_torch/models/sv.py", "sv_filter")]


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    for mod in _imports(_tree(path)):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "dfm_tpu"), (
            f"{path.relative_to(ROOT)} imports {mod}")


@pytest.mark.parametrize("pkg", ["fleet", "sched", "obs", "serve", "estim",
                                 "models"])
def test_the_walk_covers_every_subpackage(pkg):
    """The import rule above walks every module of the port, the fleet's
    copied planners (``fleet``, ``sched``, ``obs``) and the model families
    (``models``) included."""
    mods = [p for p in PORT_FILES if p.parent.name == pkg]
    assert len(mods) >= 2, f"dfm_tpu_torch/{pkg}: {mods}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_time_time(path):
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "time"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "time"):
            raise AssertionError(
                f"time.time() at {path.relative_to(ROOT)}:{node.lineno}")


def _enters_highest_precision(fn):
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                call = item.context_expr
                if (isinstance(call, ast.Call)
                        and getattr(call.func, "id", None)
                        == "highest_precision"):
                    return True
    return False


@pytest.mark.parametrize("rel,name", FIT_DRIVERS)
def test_fit_drivers_enter_highest_precision(rel, name):
    tree = _tree(ROOT / rel)
    fns = [n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef) and n.name == name]
    assert len(fns) == 1, f"{rel}:{name} not found"
    assert _enters_highest_precision(fns[0]), f"{rel}:{name}"


def test_every_fit_or_em_entry_point_is_listed():
    listed = {(r, n) for r, n in FIT_DRIVERS}
    for path in sorted((ROOT / "dfm_tpu_torch").rglob("*.py")):
        rel = str(path.relative_to(ROOT))
        for node in ast.walk(_tree(path)):
            if (isinstance(node, ast.FunctionDef)
                    and (node.name == "fit" or node.name.startswith("run_em"))):
                assert (rel, node.name) in listed, f"{rel}:{node.name}"


def test_default_backend_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs")
    Y = np.random.default_rng(0).standard_normal((30, 40))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dtt.fit(dtt.DynamicFactorModel(2), Y, max_iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dtt.TorchBackend()


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((40, 45))
    Y[rng.random(Y.shape) < 0.1] = np.nan
    kernels.reset_launches()
    res = dtt.fit(dtt.DynamicFactorModel(2), Y, max_iters=3, tol=0.0,
                  backend=dtt.TorchBackend(device="cpu"))
    assert res.filter == "info" and res.n_iters == 3
    res = dtt.fit(dtt.DynamicFactorModel(2), Y[:30], max_iters=2, tol=0.0,
                  backend=dtt.TorchBackend(device="cpu"), fused=True,
                  keep_session=True)
    res.session.update(Y[30:32])
    Yb = rng.standard_normal((2, 30, 12))
    res = dtt.fit_many(dtt.DFMBatchSpec(Y=Yb, model=dtt.DynamicFactorModel(2)),
                       backend=dtt.TorchBackend(device="cpu"), max_iters=3,
                       tol=0.0)
    assert list(res.n_iters) == [3, 3] and res.host_reads == 2
    Y0 = np.where(np.isnan(Y), 0.0, Y)
    base = dtt.fit(dtt.DynamicFactorModel(2), Y0[:30], max_iters=2,
                   backend=dtt.TorchBackend(device="cpu"))
    fl = dtt.open_fleet([base, base], [Y0[:30], Y0[:30]], capacity=34,
                        max_update_rows=2, max_iters=2,
                        backend=dtt.TorchBackend(device="cpu"))
    fl.submit("t0", Y0[30:32])
    fl.submit("t1", Y0[30:31])
    assert fl.drain()["t0"][0].t == 32
    res = dtt.fit(dtt.MixedFreqSpec(n_monthly=40, n_quarterly=5, n_factors=4),
                  Y, max_iters=2, tol=0.0,
                  backend=dtt.TorchBackend(device="cpu"))
    assert res.state_T.shape == (20,) and len(res.logliks) == 2
    res = dtt.fit(dtt.SVSpec(n_factors=2, n_particles=16, n_smooth_draws=4),
                  Y0, max_iters=1, backend=dtt.TorchBackend(device="cpu"))
    assert res.h_smooth.shape == (40, 2) and len(res.logliks) == 2
    res = dtt.fit(dtt.DynamicFactorModel(2), Y, max_iters=2, tol=0.0,
                  backend=dtt.TorchBackend(device="cpu", filter="pit"))
    assert res.filter == "pit" and res.n_iters == 2
    res = dtt.fit(dtt.DynamicFactorModel(2), Y[:, :20], max_iters=2,
                  tol=0.0, backend=dtt.TorchBackend(device="cpu"))
    assert res.filter == "dense" and res.n_iters == 2
    res = dtt.fit(dtt.DynamicFactorModel(11), Y, max_iters=1, tol=0.0,
                  backend=dtt.TorchBackend(device="cpu", filter="pit_qr"))
    assert res.filter == "pit_qr" and res.n_iters == 1
    p0 = TP.from_numpy(res.params)
    Yt, Wt = torch.as_tensor(Y0), torch.as_tensor(np.isfinite(Y) * 1.0)
    for f_filter, f_smoother in ((tpf.pit_filter, tpf.pit_smoother),
                                 (tpf.pit_qr_filter, tpf.pit_qr_smoother)):
        kf = f_filter(Yt, p0, mask=Wt, scan_impl="associative")
        f_smoother(kf, p0, scan_impl="associative")
    assert set(kernels.LAUNCHES) == {"quad_local", "obs_stats", "mstep_rows",
                                     "info_scan", "rts_smoother",
                                     "ss_cov_path", "affine_scan",
                                     "qr_elements", "qr_scan", "ring_append",
                                     "batched_info_scan", "batched_rts",
                                     "batched_quad", "batched_solve_rows",
                                     "batched_ring_append",
                                     "batched_obs_stats",
                                     "batched_quad_masked",
                                     "batched_mstep_rows", "lowrank_basis",
                                     "lowrank_scan", "lowrank_smoother",
                                     "tvl_obs_stats", "tvl_quad",
                                     "loading_filter", "loading_smoother",
                                     "obs_stats_wide", "info_scan_wide",
                                     "rts_smoother_wide", "quad_local_wide",
                                     "sv_rbpf", "sv_ffbs", "pit_elements",
                                     "pit_scan", "dense_filter",
                                     "mstep_rows_wide", "ss_cov_path_wide",
                                     "affine_scan_wide",
                                     "batched_info_scan_wide",
                                     "batched_rts_wide", "batched_quad_wide",
                                     "batched_quad_masked_wide",
                                     "batched_solve_rows_wide",
                                     "batched_obs_stats_wide",
                                     "batched_mstep_rows_wide",
                                     "obs_stats_gen", "info_scan_gen",
                                     "rts_smoother_gen", "quad_local_gen",
                                     "mstep_rows_gen",
                                     "batched_info_scan_gen",
                                     "batched_rts_gen", "batched_quad_gen",
                                     "batched_quad_masked_gen",
                                     "batched_solve_rows_gen",
                                     "batched_obs_stats_gen",
                                     "batched_mstep_rows_gen",
                                     "ss_cov_path_gen", "affine_scan_gen",
                                     "pit_elements_gen", "pit_scan_gen",
                                     "qr_elements_gen", "qr_scan_gen",
                                     "tvl_obs_stats_wide",
                                     "tvl_obs_stats_gen", "tvl_quad_wide",
                                     "tvl_quad_gen", "loading_filter_gen",
                                     "loading_smoother_gen", "sv_rbpf_gen",
                                     "sv_ffbs_gen", "lowrank_basis_gen",
                                     "lowrank_scan_gen",
                                     "lowrank_smoother_gen",
                                     "dense_filter_gen", "pit_assoc",
                                     "pit_assoc_gen", "qr_assoc",
                                     "qr_assoc_gen"}
    assert all(v == 0 for v in kernels.LAUNCHES.values())
