"""Optimizers — port of ``repro/optim``: AdamW (gradient compression comes
with the multi-GPU slice)."""
