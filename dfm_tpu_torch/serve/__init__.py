"""Serving: single-tenant streaming nowcast sessions (``session``), and
the capacity-buffer kernels K13 / K13b with the fleet's batched tick
(``batched``; the fleet itself is ``dfm_tpu_torch.fleet``)."""

from .session import NowcastSession, SessionUpdate, open_session

__all__ = ["NowcastSession", "SessionUpdate", "open_session"]
