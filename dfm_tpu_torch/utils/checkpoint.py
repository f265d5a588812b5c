"""EM checkpoints and session snapshots: atomic npz files (a copy).

The port's own copy of the JAX package's ``dfm_tpu.utils.checkpoint``
(framework-free NumPy; the port imports nothing of ``dfm_tpu``).  It reads
and writes the same files: the six params fields, ``iter``, ``logliks``,
``converged``, an optional ``fingerprint``, ``schema_version`` and any
extras, so a session snapshot written by either package restores in the
other (``serve.session.NowcastSession.snapshot`` / ``restore``).

Checkpoints carry a data/model fingerprint (hash of the panel bytes, mask
pattern and model config) so a checkpoint from a different dataset that
happens to share (N, k) is never silently used as a warm start; the stored
``iter`` counts the EM iterations the params embody.  The port's ``fit``
has no ``checkpoint_path`` yet (ROADMAP Queue 1 item 3); sessions use
``save_checkpoint`` and ``panel_fingerprint``.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from ..backends.cpu_ref import SSMParams

__all__ = ["save_checkpoint", "load_checkpoint", "data_fingerprint",
           "warm_fingerprint", "panel_fingerprint", "panel_mismatch",
           "SNAPSHOT_SCHEMA_VERSION", "check_schema_version",
           "fsync_dir"]

_FIELDS = ("Lam", "A", "Q", "R", "mu0", "P0")

# Stamped into every npz this module writes.  Bump when the on-disk
# layout changes incompatibly; readers refuse FUTURE versions loudly
# (check_schema_version) instead of surfacing a format drift as an
# opaque KeyError deep in restore.
SNAPSHOT_SCHEMA_VERSION = 1


def check_schema_version(z, path: str) -> None:
    """Refuse snapshots written by a future schema, naming both versions.

    ``z`` is an open ``np.load`` handle (or any mapping with ``in`` /
    ``__getitem__``).  Files WITHOUT a stamp (pre-versioning) are
    accepted — they predate the scheme and their layout is version 1.
    Raises ``ValueError`` so callers that normally swallow corrupt files
    must re-raise it explicitly (a version refusal is actionable, a torn
    file is not)."""
    if "schema_version" not in z:
        return
    found = int(np.asarray(z["schema_version"]))
    if found > SNAPSHOT_SCHEMA_VERSION:
        raise ValueError(
            f"snapshot {path!r} carries schema_version={found}, but this "
            f"build reads schema_version<={SNAPSHOT_SCHEMA_VERSION}; it was "
            "written by a newer build — upgrade this process (or re-write "
            "the snapshot with the older build) instead of guessing at the "
            "layout")


def fsync_dir(d: str) -> None:
    """Best-effort fsync of a directory entry (makes a rename durable)."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def data_fingerprint(Y: np.ndarray, mask, model) -> str:
    """Stable hash of (panel bytes, mask pattern, model config)."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(Y, np.float64)).tobytes())
    if mask is not None:
        h.update(np.ascontiguousarray(
            np.asarray(mask, np.uint8)).tobytes())
    h.update(repr(model).encode())
    return h.hexdigest()


def warm_fingerprint(shape, model, has_missing: bool) -> str:
    """STRUCTURAL fingerprint for ``fit(warm_start=...)`` validation.

    Deliberately value-free (panel shape + model config + missing-data
    presence, NOT data bytes): warm-refitting on *updated values* of the
    same panel shape is the intended serving flow — recompiles only come
    from structural change, which is exactly what this hash captures.
    Contrast ``data_fingerprint`` (checkpoint/resume), which must reject
    different *data*."""
    h = hashlib.sha1()
    h.update(repr((tuple(int(d) for d in shape), repr(model),
                   bool(has_missing))).encode())
    return h.hexdigest()


def panel_fingerprint(Y: np.ndarray, mask=None) -> str:
    """CONTENT fingerprint of one (panel, mask) pair.

    Value-sensitive, model-free: two host copies of the same data hash
    equal, so the fused warm-refit device-panel cache can survive a
    ``Y.copy()`` between fits (the serving flow ``warm_fingerprint``
    deliberately ignores values for).  NaN patterns hash via the f64
    byte image (all payloads normalized by the asarray cast)."""
    Y = np.ascontiguousarray(np.asarray(Y, np.float64))
    h = hashlib.sha1()
    h.update(repr(Y.shape).encode())
    h.update(Y.tobytes())
    if mask is not None:
        h.update(b"mask")
        h.update(np.ascontiguousarray(np.asarray(mask, np.uint8)).tobytes())
    return h.hexdigest()


def panel_mismatch(Y_a, mask_a, Y_b, mask_b) -> Optional[str]:
    """Name the first differing field between two (panel, mask) pairs.

    Returns None when they are content-equal (NaNs compare equal — both
    encode "missing"), else a short human-readable reason — "panel shape",
    "panel dtype", "mask presence", "mask pattern", or "panel values" —
    used by the fused warm-refit cache to say WHY a re-upload happened."""
    A, B = np.asarray(Y_a), np.asarray(Y_b)
    if A.shape != B.shape:
        return f"panel shape ({A.shape} vs {B.shape})"
    if A.dtype != B.dtype:
        return f"panel dtype ({A.dtype} vs {B.dtype})"
    if (mask_a is None) != (mask_b is None):
        return "mask presence (one fit passed mask=, the other did not)"
    if mask_a is not None and not np.array_equal(np.asarray(mask_a),
                                                 np.asarray(mask_b)):
        return "mask pattern"
    if not np.array_equal(A, B, equal_nan=A.dtype.kind == "f"):
        return "panel values"
    return None


def save_checkpoint(path: str, params, it: int, logliks,
                    fingerprint: Optional[str] = None,
                    converged: bool = False,
                    extra: Optional[dict] = None) -> None:
    """Atomic durable write (tmp + fsync + rename) of EM state.

    ``extra``: additional arrays merged into the npz under their own keys
    (the serve-session snapshot stores its live panel + config here);
    ``load_checkpoint`` reads only the EM fields and ignores extras, so
    a session snapshot is ALSO a valid warm-start checkpoint.

    The tmp file is fsync'd before the rename and the directory entry
    after it, so a crash at ANY point leaves either the old snapshot or
    the new one — never a truncated npz.  Every file is stamped with
    ``schema_version`` (see ``check_schema_version``)."""
    arrays = {f: np.asarray(getattr(params, f), np.float64) for f in _FIELDS}
    arrays["iter"] = np.asarray(it)
    arrays["logliks"] = np.asarray(logliks, np.float64)
    arrays["converged"] = np.asarray(bool(converged))
    if fingerprint is not None:
        arrays["fingerprint"] = np.asarray(fingerprint)
    for k, v in (extra or {}).items():
        if k in arrays:
            raise ValueError(f"extra key {k!r} collides with an EM "
                             f"checkpoint field")
        arrays[k] = np.asarray(v)
    arrays.setdefault("schema_version", np.asarray(SNAPSHOT_SCHEMA_VERSION))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, fingerprint: Optional[str] = None,
                    on_mismatch: str = "ignore"
                    ) -> Optional[Tuple[SSMParams, int, np.ndarray, bool]]:
    """Returns (params, completed_iters, logliks, converged) or None if
    absent, unreadable, or fingerprint-mismatched.  When a fingerprint is
    expected, a checkpoint WITHOUT one (pre-fingerprint file) is also
    rejected — accepting it would silently warm-start from possibly-foreign
    params, the exact failure the fingerprint exists to prevent.

    ``on_mismatch``: "ignore" returns None on a fingerprint mismatch —
    ``fit`` uses it so foreign data cold-starts with the full iteration
    budget; "raise" raises ``ValueError`` instead, for callers who need
    pointing an existing checkpoint at CHANGED data to fail loudly rather
    than refit from scratch and overwrite the old state."""
    if on_mismatch not in ("ignore", "raise"):
        raise ValueError(f"on_mismatch must be 'ignore' or 'raise'; "
                         f"got {on_mismatch!r}")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            check_schema_version(z, path)   # future-version refusal: loud
            matches = (fingerprint is None
                       or ("fingerprint" in z
                           and str(z["fingerprint"]) == fingerprint))
            if matches:
                params = SSMParams(*(z[f] for f in _FIELDS))
                converged = bool(z["converged"]) if "converged" in z else False
                out = (params, int(z["iter"]), np.asarray(z["logliks"]),
                       converged)
            else:
                out = None
    except ValueError:
        raise              # schema_version from the future — actionable
    except Exception:
        return None        # unreadable/corrupt file: caller starts fresh
    if out is None and on_mismatch == "raise":
        raise _fingerprint_error(path)
    return out


def _fingerprint_error(path: str) -> ValueError:
    return ValueError(
        f"checkpoint {path!r} was written for different data / mask / "
        "model (fingerprint mismatch); resuming would either warm-start "
        "from foreign params or silently overwrite the old run — delete "
        "the file or use a different checkpoint_path")
