"""Utilities — port of ``repro/utils``: ``cost``, the step profiler's
counterpart of the reference's HLO cost model (``utils/hlo.py``)."""
