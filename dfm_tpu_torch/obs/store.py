"""The read side of the run registry, for the fleet's cost model.

A copy of the part of ``dfm_tpu.obs.store`` that
``fleet.admission._load_model`` uses: ``runs_dir`` resolves the registry
directory (an explicit path, else ``$DFM_RUNS``; ``DFM_RUNS=""`` disables
it; unset, the default ``.dfm_runs/``) and ``RunStore.load`` reads its
append-only ``runs.jsonl``, whose ``profile`` records calibrate
``obs.cost.fit_cost_model``.  Both packages read the same files.  Writing
records (bench CLIs, traced fits, backfill) is not ported.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

__all__ = ["RUNS_ENV", "DEFAULT_DIR", "RUNS_FILE", "runs_dir", "RunStore"]

RUNS_ENV = "DFM_RUNS"
DEFAULT_DIR = ".dfm_runs"
RUNS_FILE = "runs.jsonl"


def runs_dir(explicit: Optional[str] = None, *,
             ambient_only: bool = False) -> Optional[str]:
    """Resolve the registry directory; ``None`` means "no registry".  With
    ``ambient_only`` only an explicit directory or ``DFM_RUNS`` counts
    (no ``DEFAULT_DIR`` fallback)."""
    if explicit:
        return str(explicit)
    env = os.environ.get(RUNS_ENV)
    if env:
        return env
    if env == "":          # explicitly disabled
        return None
    return None if ambient_only else DEFAULT_DIR


class RunStore:
    """Append-only JSONL registry in ``<dir>/runs.jsonl`` (read side)."""

    def __init__(self, path: str):
        self.dir = str(path)
        self.file = os.path.join(self.dir, RUNS_FILE)

    def load(self) -> List[Dict[str, Any]]:
        """All records, oldest first; corrupt/truncated lines are skipped
        (a run may die mid-append — history must still load)."""
        if not os.path.exists(self.file):
            return []
        out = []
        with open(self.file) as f:
            for i, ln in enumerate(f, 1):
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                except json.JSONDecodeError:
                    print("warning: %s line %d: corrupt record skipped"
                          % (self.file, i), file=sys.stderr)
                    continue
                if isinstance(rec, dict) and "run_id" in rec:
                    out.append(rec)
        return out
