"""Host utilities of the port (``data``, ``dgp``, ``checkpoint``) and the
refusal of keywords the JAX package takes for work not ported yet."""

from __future__ import annotations

__all__ = ["refuse_unported"]


def refuse_unported(fn: str, *asked) -> None:
    """Raise ``NotImplementedError`` for the first of ``asked``, triples
    (keyword, whether the call asks for it, the ROADMAP Queue 1 item that
    ports it), that the call asks for: a keyword the JAX package's ``fn``
    takes, whose work the port does not have yet, is refused by name and
    item instead of by a ``TypeError``."""
    for kw, on, item in asked:
        if on:
            raise NotImplementedError(
                f"{fn}({kw}=) is not ported to dfm_tpu_torch yet: ROADMAP "
                f"Queue 1 item {item}")
