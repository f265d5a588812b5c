"""Observability, the part the fleet needs: the calibrated cost model
(``cost``) and the read side of the run registry (``store``)."""
