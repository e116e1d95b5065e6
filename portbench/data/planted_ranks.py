"""The gang cells' generator: each rank's rows of ``data/planted_blocked.py``'s
planted spectrum, made from (seed, rank). The code lives with the
reference, which replays every rank's rows with it
(``reference/planted_ranks.py``)."""

from portbench.reference.planted_ranks import column_sums, make

__all__ = ["make", "column_sums"]
