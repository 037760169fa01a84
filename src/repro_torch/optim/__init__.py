"""Optimizers — port of ``repro/optim``: AdamW and blockwise gradient
compression with error feedback (``grad_compress``)."""
