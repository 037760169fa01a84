"""Blockwise-quantized gradient compression with error feedback — port of
``repro/optim/grad_compress.py``.

Gradients are blockwise k-bit quantized (``core/blockwise``, the dynamic
codebook, 8 bits by default, block 256) and dequantized again, as before a
data-parallel all-reduce that would move 16/k times fewer bytes; error
feedback carries each leaf's quantization residual into the next step
(f32), so convergence is kept.  The train step applies the round trip
between the gradients and AdamW, as the reference's ``train/step.py``
does; on a mesh each rank compresses its slices as the whole leaves would
be (``compress_tree(placement=)``).  Leaves of fewer than 1,024 elements
pass through with a zero error.  On the card each compressed leaf is one
launch of the flat encode kernel (``csrc/quantize.cu``, through
``core/blockwise.encode``).
"""

from __future__ import annotations

import math

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


def _block_run(shape, spec, sharder, block_size: int) -> bool:
    """Whether this rank's slice of a leaf of ``shape`` placed by ``spec``
    is one run of the whole leaf's row-major blocks: a contiguous flat range
    (split on one dim, every dim before it of size 1) from a block boundary,
    whole blocks long or ending where the leaf does."""
    split = [d for d, e in enumerate(spec) if e is not None and sharder._axis_size(e) > 1]
    if not split:
        return True
    d = split[0]
    if len(split) > 1 or math.prod(shape[:d]) != 1:
        return False
    i, n = sharder.coord(spec[d])
    inner = math.prod(shape[d + 1:])
    length = shape[d] // n * inner
    start = i * length
    return start % block_size == 0 and (length % block_size == 0
                                        or start + length == math.prod(shape))


def compress_tree(grads, errors, *, bits: int = 8, block_size: int = 256, placement=None,
                  inplace: bool = False):
    """Error-feedback compression of every gradient leaf of at least
    ``MIN_ELEMENTS`` elements: (compressed grads, new errors), trees of
    ``grads``' structure; ``errors`` None starts from zero.  ``inplace``
    writes them into the given trees (the same numbers; one leaf's new
    values at a time beside them).

    With ``placement`` (``models/sharding.TrainPlacement``) the trees hold
    this rank's slices, and the result is this rank's slice of what the
    whole leaves give, bit for bit: blocks run over the whole leaf's
    row-major order, so a slice that is a run of whole blocks is encoded
    where it is, and any other slice's leaf (and error) is gathered whole,
    encoded, and cut again — the same one launch a compressed leaf, over
    the whole leaf's bytes."""
    flat_g = leaves(grads)
    flat_e = leaves(errors) if errors is not None else [
        torch.zeros_like(g, dtype=torch.float32) for g in flat_g]
    on = placement is not None and placement.on
    specs = placement.specs if on else [None] * len(flat_g)
    shapes = placement.shapes if on else [tuple(g.shape) for g in flat_g]

    def one(g, e, spec, shape):
        if math.prod(shape) < MIN_ELEMENTS:
            return g, torch.zeros_like(g, dtype=torch.float32)
        s = placement.sharder if on else None
        if not on or _block_run(shape, spec, s, block_size):
            g_hat, err = compress_decompress(g, bits=bits, block_size=block_size, error=e)
        else:
            g_hat, err = compress_decompress(s.whole(g, spec), bits=bits,
                                             block_size=block_size, error=s.whole(e, spec))
            g_hat, err = s.cut(g_hat, spec), s.cut(err, spec)
        return (g.copy_(g_hat), e.copy_(err)) if inplace else (g_hat, err)

    out = [one(g, e, sp, n) for g, e, sp, n in zip(flat_g, flat_e, specs, shapes, strict=True)]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])


def init_error_state(grads_shape_tree):
    """Zero f32 errors for a tree of gradients (or parameters)."""
    return unflatten(grads_shape_tree, [torch.zeros(g.shape, dtype=torch.float32,
                                                    device=g.device)
                                        for g in leaves(grads_shape_tree)])
