"""The kernel build queue (``dfm_tpu_torch.kernels``) when a compile can
neither start nor finish: the job ends with the error, ``build`` raises it
instead of waiting, and the queue's thread is gone, so a later build starts
a new one.  No compiler runs: the start and the process are stand-ins, and
the libraries go to a temporary directory."""

import time

import pytest

from dfm_tpu_torch import kernels


class _Ended:
    """A compile that has ended with code 0 (its output never written)."""
    returncode = 0
    pid = -1

    def poll(self):
        return 0


def _cannot_start(nvcc, key):
    raise OSError(24, "Too many open files")


def _output_missing(nvcc, key):
    job = kernels._JOBS[key]
    job.out.with_suffix(".log").write_text("")
    return _Ended(), job.out.with_suffix(".missing.tmp"), time.perf_counter()


@pytest.mark.parametrize("start,msg", [(_cannot_start, "Too many open files"),
                                       (_output_missing, "FileNotFoundError")])
def test_a_failed_job_raises_and_frees_the_queue(monkeypatch, tmp_path,
                                                 start, msg):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels, "_start", start)
    monkeypatch.setattr(kernels, "_JOBS", {})
    monkeypatch.setattr(kernels, "_QUEUE", [])
    monkeypatch.setattr(kernels, "_RUNNING", {})
    monkeypatch.setattr(kernels, "_THREAD", None)
    with pytest.raises(RuntimeError, match=msg):
        kernels.build()
    assert all(job.done.is_set() and job.error
               for job in kernels._JOBS.values())
    for _ in range(100):                 # the thread ends on its next turn
        if kernels._THREAD is None:
            break
        time.sleep(0.05)
    assert kernels._THREAD is None and kernels.build_pending() == 0


def test_the_queue_builds_every_source_once_a_dtype_first_ones_first():
    """``chip_smoke.BUILD_FIRST`` names every source of the kernel tables
    once, the first group's (dense) sources first, then two of the longest
    compiles, sv_rbpf.cu and tvl's tv_smoother.cu; the
    generic K4 pair and K11 pair build apart from their k <= 16 kernels
    (their own sources), K11-bwd's k <= 16 kernel apart from K11-fwd's,
    the generic rank-r and dense kernels apart too, and the associative
    scans apart from the blocked ones, last."""
    import chip_smoke as cs
    tables = (*kernels.KERNELS.values(), *kernels.PROBES.values(),
              *kernels.QUERIES.values())
    sources = {src for src, _ in tables}
    assert len(cs.BUILD_FIRST) == len(set(cs.BUILD_FIRST)) == len(sources)
    assert set(cs.BUILD_FIRST) == sources
    assert kernels._sources(cs.BUILD_FIRST) == list(cs.BUILD_FIRST)
    assert cs.PHASES[:2] == ("dense", "tvl")
    assert cs.BUILD_FIRST[:4] == ("dense_filter.cu", "step_chain.cu",
                                  "sv_rbpf.cu", "tv_smoother.cu")
    assert kernels.KERNELS["loading_smoother"][0] == "tv_smoother.cu"
    assert kernels.KERNELS["loading_filter"][0] == "tv_loadings.cu"
    for narrow, gen, source in (
            ("info_scan", "info_scan_gen", "info_scan_gen.cu"),
            ("rts_smoother", "rts_smoother_gen", "info_scan_gen.cu"),
            ("batched_info_scan", "batched_info_scan_gen",
             "info_scan_gen.cu"),
            ("loading_filter", "loading_filter_gen", "tv_loadings_gen.cu"),
            ("loading_smoother", "loading_smoother_gen",
             "tv_loadings_gen.cu"),
            ("lowrank_scan", "lowrank_scan_gen", "gen_filters.cu"),
            ("dense_filter", "dense_filter_gen", "gen_filters.cu")):
        assert kernels.KERNELS[gen][0] == source
        assert kernels.KERNELS[narrow][0] != source
    assert kernels.QUERIES["loading_smoother_gen_slots"][0] == \
        "tv_loadings_gen.cu"
    # The log-depth scans (K14-assoc, K8-assoc) are a source of their own,
    # queued last: their group runs last.
    assert cs.BUILD_FIRST[-1] == "pit_assoc.cu" and cs.PHASES[-1] == "assoc"
    for name in ("pit_assoc", "pit_assoc_gen", "qr_assoc", "qr_assoc_gen"):
        assert kernels.KERNELS[name][0] == "pit_assoc.cu"
    assert kernels.KERNELS["pit_scan"][0] == "pit_scan.cu"
    assert kernels.KERNELS["qr_scan"][0] == "qr_scan.cu"


def test_a_compile_runs_niced_one_a_dtype(monkeypatch, tmp_path):
    """Each job is one nvcc for one source and dtype under ``nice -n 19``
    (the caller's threads keep their cores), into a temporary output."""
    seen = []

    class _Proc:
        def __init__(self, cmd, **kw):
            seen.append(cmd)
            self.pid = -1

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.subprocess, "Popen", _Proc)
    monkeypatch.setattr(kernels.shutil, "which",
                        lambda name: f"/usr/bin/{name}")
    monkeypatch.setattr(kernels, "_JOBS", {})
    key = ("gen_filters.cu", "f64")
    kernels._JOBS[key] = kernels._Job(kernels._lib_path(*key))
    kernels._start("nvcc", key)
    (cmd,) = seen
    assert cmd[:4] == ["/usr/bin/nice", "-n", "19", "nvcc"]
    assert "-DDFM_DTYPE=64" in cmd and cmd[-1].endswith("gen_filters.cu")
