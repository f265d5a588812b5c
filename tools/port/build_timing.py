#!/usr/bin/env python3
"""Time the kernel build's compiles on this host, without a card.

    python3 tools/port/build_timing.py [MODE ...] [--width W]
                                       [--sources a.cu,b.cu]

Each MODE compiles every ``dfm_tpu_torch/csrc`` source of the kernel
tables (or the ``--sources`` named) into a scratch directory under
``build/``, at most W ``nvcc`` at a time (default: one a core), in table
order:

    single   one nvcc per source and dtype (``-DDFM_DTYPE=32`` and ``64``)
    both     one nvcc per source, both dtypes' entry points in one library

Prints, per mode, one JSON line a compile (source, wall seconds, the CPU
seconds of nvcc and the tools it ran) and a total: the mode's wall, the
summed CPU and the longest compile.  Nothing is loaded or launched.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from dfm_tpu_torch import kernels  # noqa: E402


def jobs(mode: str, sources=None) -> list:
    """(label, extra flags, source) of every compile of ``mode``, over
    ``sources`` (default: every source of the kernel tables)."""
    out = []
    for source in sources or kernels._sources():
        if mode == "single":
            out += [(f"{source}:{d}", [f"-DDFM_DTYPE={d}"], source)
                    for d in (32, 64)]
        elif mode == "both":
            out.append((source, [], source))
        else:
            raise SystemExit(f"build_timing: unknown mode {mode!r}")
    return out


def run(mode: str, width: int, scratch: Path, sources=None) -> dict:
    nvcc = kernels._nvcc()
    todo = jobs(mode, sources)
    running, recs = {}, []
    t0 = time.perf_counter()
    while todo or running:
        while todo and len(running) < width:
            label, extra, source = todo.pop(0)
            out = scratch / f"{label.replace(':', '-')}.so"
            cmd = [nvcc, *kernels.NVCC_FLAGS, *extra, "-o", str(out),
                   str(kernels.CSRC / source)]
            # The log goes to a file: ptxas's -v report of a large source
            # fills a pipe and would stall the compile.
            log = out.with_suffix(".log")
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh,
                                        stderr=subprocess.STDOUT)
            running[proc.pid] = (proc, label, time.perf_counter(), log)
        pid, status, ru = os.wait4(-1, 0)
        if pid not in running:
            continue
        proc, label, began, log = running.pop(pid)
        proc.returncode = os.waitstatus_to_exitcode(status)
        rec = {"mode": mode, "compile": label,
               "wall_s": time.perf_counter() - began,
               "cpu_s": ru.ru_utime + ru.ru_stime,
               "rc": os.waitstatus_to_exitcode(status)}
        if rec["rc"] != 0:
            rec["error"] = log.read_text()[-2000:]
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    total = {"mode": mode, "width": width, "compiles": len(recs),
             "wall_s": time.perf_counter() - t0,
             "cpu_s": sum(r["cpu_s"] for r in recs),
             "longest": max(recs, key=lambda r: r["wall_s"])["compile"],
             "longest_s": max(r["wall_s"] for r in recs),
             "failed": [r["compile"] for r in recs if r["rc"] != 0]}
    print(json.dumps({"build_timing": total}), flush=True)
    return total


def main(argv: list) -> int:
    width = os.cpu_count() or 1
    if "--width" in argv:
        i = argv.index("--width")
        width = int(argv[i + 1])
        del argv[i:i + 2]
    sources = None
    if "--sources" in argv:
        i = argv.index("--sources")
        sources = argv[i + 1].split(",")
        del argv[i:i + 2]
    modes = argv or ["single", "both"]
    scratch = ROOT / "build" / "build_timing"
    scratch.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"nvcc": kernels._nvcc(), "cpus": os.cpu_count(),
                      "version": subprocess.run(
                          [kernels._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]}),
          flush=True)
    failed = [m for m in modes
              if run(m, width, scratch, sources)["failed"]]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
