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
