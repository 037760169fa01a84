"""Training — port of ``repro/train``: the train step and the loop, on one
device."""
