"""Blockwise-quantized gradient compression with error feedback — port of
``repro/optim/grad_compress.py``.

Gradients are blockwise k-bit quantized (``core/blockwise``, the dynamic
codebook, 8 bits by default, block 256) and dequantized again, as before a
data-parallel all-reduce that would move 16/k times fewer bytes; error
feedback carries each leaf's quantization residual into the next step
(f32), so convergence is kept.  On one device there is no collective: the
train step applies the round trip between the gradients and AdamW, as the
reference's ``train/step.py`` does.  Leaves of fewer than 1,024 elements
pass through with a zero error.  On the card each compressed leaf is one
launch of the flat encode kernel (``csrc/quantize.cu``, through
``core/blockwise.encode``).
"""

from __future__ import annotations

import torch

from repro_torch.core.blockwise import decode, encode
from repro_torch.core.codebooks import make_codebook
from repro_torch.tree import leaves, unflatten

#: leaves smaller than this pass through uncompressed
MIN_ELEMENTS = 1024


def compress_decompress(g: torch.Tensor, *, bits: int = 8, block_size: int = 256,
                        error: torch.Tensor | None = None):
    """Quantize and dequantize a gradient tensor: (g_hat in g's dtype,
    the new f32 error)."""
    cb = make_codebook("dynamic", bits, device=g.device)
    g32 = g.to(torch.float32)
    if error is not None:
        g32 = g32 + error
    q = encode(g32, cb, block_size)
    g_hat = decode(q, cb, g32.shape, out_dtype=torch.float32)
    return g_hat.to(g.dtype), g32 - g_hat


def compress_tree(grads, errors, *, bits: int = 8, block_size: int = 256):
    """Error-feedback compression of every gradient leaf of at least
    ``MIN_ELEMENTS`` elements: (compressed grads, new errors), trees of
    ``grads``' structure; ``errors`` None starts from zero."""

    def one(g, e):
        if g.numel() < MIN_ELEMENTS:
            return g, torch.zeros_like(g, dtype=torch.float32)
        return compress_decompress(g, bits=bits, block_size=block_size, error=e)

    flat_g = leaves(grads)
    flat_e = leaves(errors) if errors is not None else [
        torch.zeros_like(g, dtype=torch.float32) for g in flat_g]
    out = [one(g, e) for g, e in zip(flat_g, flat_e, strict=True)]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])


def init_error_state(grads_shape_tree):
    """Zero f32 errors for a tree of gradients (or parameters)."""
    return unflatten(grads_shape_tree, [torch.zeros(g.shape, dtype=torch.float32,
                                                    device=g.device)
                                        for g in leaves(grads_shape_tree)])
