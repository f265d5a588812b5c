"""Serving: single-tenant streaming nowcast sessions (``session``) and the
capacity-buffer kernel K13 (``batched``)."""

from .session import NowcastSession, SessionUpdate, open_session

__all__ = ["NowcastSession", "SessionUpdate", "open_session"]
