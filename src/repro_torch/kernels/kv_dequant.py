"""k-bit blockwise-quantized KV-cache layout: encode and dequant — port of
``repro/kernels/kv_dequant.py``.

Each cached token row holds ``feat = n_kv_heads * head_dim`` features,
chunked into blocks along that feature dim:

    packed  int32 (uint32 bits) [..., S_c, feat // cpw]
    scales  bf16                [..., S_c, feat // bs]

Blocks and words never cross tokens, so every byte of a cached token lives
in its row.  Only k in {4, 8} and the static codebooks (int, float,
dynamic) serve a streaming cache.

A decode step reads the cache through ``kernels/kv_attention``.  Its fused
kernel dequantizes in registers inside the attention; the shapes it does
not take (``kv_attention.fused_takes``) are read through ``dequant_kv``,
one launch a layer of the CUDA kernel ``csrc/kv_dequant.cu`` for K and V
together, which replaces the TPU kernel ``dequant_rows_pallas``
(src/repro/kernels/kv_dequant.py:159) and reads a paged cache through its
page map.  ``dequant_rows`` (rows) and ``dequant_pages`` (pages) launch the
same kernel on one leaf.  For CPU tensors each runs the plain version,
``dequant_rows_ref`` (``dequant_kv_plain`` for a layer).  The reference
makes its kernel opt-in (``kv_use_kernel``); here a CUDA tensor always takes
the kernel.  What bounds the kernel (bytes; at decode shapes, launch
latency) and its design are noted in its source.

The paged pool (``serving/pages.py``) stores every leaf page-major,
[n_pages, ps, ...]: ``gather_pages`` reads a leaf through a page map into
the slot-pool row layout, which the plain versions read.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.codebooks import codebook_boundaries, make_codebook
from repro_torch.kernels import _build
from repro_torch.utils import cost


class KVQuantSpec(NamedTuple):
    """Static description of a quantized KV cache."""

    bits: int
    block_size: int
    dtype_name: str = "float"


def kv_spec(cfg) -> Optional[KVQuantSpec]:
    """The cache-quantization spec an ArchConfig asks for (None = bf16)."""
    bits = getattr(cfg, "kv_bits", 16)
    if bits is None or bits >= 16:
        return None
    if bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4, 8 or 16, got {bits}")
    if cfg.kv_dtype == "quantile":
        raise ValueError("quantile codebooks cannot serve a streaming KV cache")
    return KVQuantSpec(bits=bits, block_size=cfg.kv_block_size, dtype_name=cfg.kv_dtype)


def kv_layout(spec: KVQuantSpec, feat: int) -> tuple[int, int, int]:
    """(block_size, n_blocks, n_words) for a ``feat``-wide token row; the
    block is clamped to the row and reduced to the gcd if it does not divide."""
    bs = min(spec.block_size, feat)
    if feat % bs:
        bs = math.gcd(bs, feat)
    cpw = packing.codes_per_word(spec.bits)
    if feat % cpw:
        raise ValueError(f"feature dim {feat} must divide into {cpw}-code words "
                         f"(kv_bits={spec.bits})")
    return bs, feat // bs, feat // cpw


def kv_codebook(spec: KVQuantSpec, device) -> torch.Tensor:
    """Sorted static codebook for the cache's data type (f32 [2**bits])."""
    return make_codebook(spec.dtype_name, spec.bits, device=device)


def encode_rows(x: torch.Tensor, spec: KVQuantSpec):
    """Blockwise-quantize token rows x [..., feat]: returns (packed int32
    [..., n_words], scales bf16 [..., n_blocks]).  Plain PyTorch, as in the
    reference (the append-quantize of a decode step)."""
    feat = x.shape[-1]
    bs, n_blocks, _ = kv_layout(spec, feat)
    xb = x.to(torch.float32).reshape(x.shape[:-1] + (n_blocks, bs))
    scales = torch.clamp(xb.abs().amax(dim=-1), min=1e-12)
    normed = xb / scales[..., None]
    bounds = codebook_boundaries(kv_codebook(spec, x.device)).contiguous()
    codes = torch.searchsorted(bounds, normed)
    packed = packing.pack(codes.reshape(x.shape[:-1] + (feat,)), spec.bits)
    return packed, scales.to(torch.bfloat16)


def dequant_rows_ref(packed, scales, spec: KVQuantSpec, feat: int,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: packed [..., W] + scales [..., NB] -> [..., feat]."""
    bs, n_blocks, _ = kv_layout(spec, feat)
    codes = packing.unpack(packed, spec.bits, feat)
    vals = kv_codebook(spec, packed.device)[codes.long()]
    vals = vals.reshape(packed.shape[:-1] + (n_blocks, bs))
    vals = vals * scales[..., None].to(torch.float32)
    return vals.reshape(packed.shape[:-1] + (feat,)).to(out_dtype)


def _lib():
    lib = _build.load("kv_dequant")
    if not getattr(lib, "_argtypes_set", False):
        lib.kv_dequant.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong]
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.kv_dequant.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def dequant_kv_cuda(leaves, spec: KVQuantSpec, feat: int, page_map=None) -> list:
    """Launch the kernel once over one or two (packed, scales) leaves of the
    same shape (a layer's K and V) on CUDA: leaves of rows [..., W] / [...,
    NB] give bf16 [..., feat]; with ``page_map`` [B, P] int32, page-major
    leaves [n_pages, ps, W] / [n_pages, ps, NB] read through the map give
    [B, P * ps, feat] (``gather_pages``'s layout, without its copy).
    Counts launches in ``.launches``."""
    bs, n_blocks, n_words = kv_layout(spec, feat)
    packed0, scales0 = leaves[0]
    if not 1 <= len(leaves) <= 2:
        raise ValueError(f"kv dequant kernel takes one or two leaves, got {len(leaves)}")
    for packed, scales in leaves:
        if packed.dtype != torch.int32 or scales.dtype != torch.bfloat16:
            raise TypeError("kv dequant kernel takes int32 packed words and bf16 scales")
        if packed.shape != packed0.shape or packed.shape[-1] != n_words \
                or tuple(scales.shape) != tuple(packed.shape[:-1]) + (n_blocks,):
            raise ValueError(f"kv dequant kernel: packed {tuple(packed.shape)} / scales "
                             f"{tuple(scales.shape)} do not fit feat={feat}, {spec}")
        if not (packed.is_contiguous() and scales.is_contiguous()):
            raise ValueError("kv dequant kernel takes contiguous leaves")
    dev = packed0.device
    if dev.type != "cuda" or any(t.device != dev for pair in leaves for t in pair):
        raise ValueError("kv dequant kernel takes leaves on one CUDA device")
    if page_map is None:
        lead, lps, rows = tuple(packed0.shape[:-1]), 0, packed0.numel() // n_words
    else:
        ps = packed0.shape[1] if packed0.ndim == 3 else 0
        if packed0.ndim != 3 or ps & (ps - 1) or page_map.ndim != 2 \
                or page_map.dtype != torch.int32 or page_map.device != dev \
                or not page_map.is_contiguous():
            raise ValueError(f"kv dequant kernel: page-major leaves [n_pages, ps, W] with ps a "
                             f"power of two and a contiguous int32 page map [B, P] on {dev}, "
                             f"got {tuple(packed0.shape)} and {tuple(page_map.shape)}")
        lead = (page_map.shape[0], page_map.shape[1] * ps)
        lps, rows = ps.bit_length() - 1, lead[0] * lead[1]
    outs = [torch.empty(lead + (feat,), dtype=torch.bfloat16, device=dev) for _ in leaves]
    ptrs = [(p.data_ptr(), s.data_ptr(), o.data_ptr()) for (p, s), o in zip(leaves, outs)]
    if len(ptrs) == 1:
        ptrs.append((None, None, None))
    codebook = kv_codebook(spec, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _lib().kv_dequant(
            *ptrs[0], *ptrs[1], codebook.data_ptr(),
            None if page_map is None else page_map.data_ptr(), lps, rows, n_words, n_blocks,
            spec.bits, bs, stream)
    _build.check(status, "kv_dequant")
    dequant_kv_cuda.launches += 1
    return outs


dequant_kv_cuda.launches = 0


def dequant_rows_cuda(packed: torch.Tensor, scales: torch.Tensor, spec: KVQuantSpec,
                      feat: int) -> torch.Tensor:
    """The kernel on one leaf of CUDA rows: packed [..., W] int32, scales
    [..., NB] bf16 -> bf16 [..., feat]."""
    return dequant_kv_cuda([(packed, scales)], spec, feat)[0]


def dequant_rows(packed, scales, spec: KVQuantSpec, feat: int,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize [..., W] / [..., NB] leaves to [..., feat]: the CUDA kernel
    for CUDA tensors (bf16 out), the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return dequant_rows_ref(packed, scales, spec, feat, out_dtype=out_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"dequant_rows runs on cuda or cpu tensors, not {packed.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the kv dequant kernel writes bf16, not {out_dtype}")
    return dequant_rows_cuda(packed.contiguous(), scales.contiguous(), spec, feat)


def gather_pages(leaf: torch.Tensor, page_map: torch.Tensor) -> torch.Tensor:
    """A page-major leaf [n_pages, ps, ...] read through ``page_map`` [B, P]
    (each row's page ids in table order): the contiguous [B, P * ps, ...]
    view in which position p of row b sits at index p, the slot pool's row
    layout.  Blocks and words run along the feature dim only, so a page
    boundary never splits a token's quantization state."""
    B, P = page_map.shape
    g = torch.index_select(leaf, 0, page_map.reshape(-1).to(torch.int64))
    return g.reshape((B, P * leaf.shape[1]) + tuple(leaf.shape[2:]))


def dequant_pages(packed, scales, page_map, spec: KVQuantSpec, feat: int,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Paged packed words [n_pages, ps, W] and scales [n_pages, ps, NB]
    read through ``page_map`` [B, P] and dequantized: [B, P * ps, feat].
    On CUDA one launch of the kernel reads the pages through the map; on the
    CPU the plain version gathers them first."""
    if packed.device.type == "cuda" and out_dtype == torch.bfloat16:
        return dequant_kv_cuda([(packed, scales)], spec, feat, page_map)[0]
    return dequant_rows(gather_pages(packed, page_map), gather_pages(scales, page_map), spec,
                        feat, out_dtype=out_dtype)


_KV_LEAVES = (("k_packed", "k_scales"), ("v_packed", "v_scales"))


def kv_rows_read(cache: dict, spec: KVQuantSpec, feat: int, page_map=None) -> tuple[int, int]:
    """(slots, bytes) a layer's read of K and V takes: every row's slots
    (through the map, the pages it names, not the pool) as stored, and the
    map."""
    _, n_blocks, n_words = kv_layout(spec, feat)
    kp = cache["k_packed"]
    rows = kp.shape[0] * kp.shape[1] if page_map is None else page_map.numel() * kp.shape[1]
    extra = 0 if page_map is None else cost.nbytes(page_map)
    return rows, 2 * rows * (4 * n_words + 2 * n_blocks) + extra


def _kv_work(cache: dict, spec: KVQuantSpec, feat: int, page_map=None) -> dict:
    """B2.2's charge: a FLOP a value; K and V read as stored, written bf16."""
    rows, read = kv_rows_read(cache, spec, feat, page_map)
    return dict(flops=2 * rows * feat, hbm_bytes=read + 2 * rows * feat * 2)


@cost.unit(_kv_work)
def dequant_kv_plain(cache: dict, spec: KVQuantSpec, feat: int, page_map=None):
    """The plain version of a layer's read: (K, V) bf16 [B, S, feat] of a
    packed cache, a paged one gathered through ``page_map`` first."""
    if page_map is not None:
        cache = {key: gather_pages(cache[key], page_map) for pair in _KV_LEAVES for key in pair}
    return tuple(dequant_rows_ref(cache[p], cache[s], spec, feat) for p, s in _KV_LEAVES)


@cost.unit(_kv_work)
def dequant_kv(cache: dict, spec: KVQuantSpec, feat: int, page_map=None):
    """A layer's K and V of a packed cache (rows, or pages through
    ``page_map``) as bf16 [B, S, feat]: one launch of the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev = cache["k_packed"].device
    if dev.type == "cuda":
        return tuple(dequant_kv_cuda([(cache[p], cache[s]) for p, s in _KV_LEAVES], spec,
                                     feat, page_map))
    if dev.type == "cpu":
        return dequant_kv_plain(cache, spec, feat, page_map)
    raise ValueError(f"dequant_kv runs on cuda or cpu tensors, not {dev}")


def kv_stored_bytes_per_token(spec: Optional[KVQuantSpec], feat: int,
                              cache_dtype_bytes: int = 2) -> float:
    """Device bytes one cached K *or* V token row occupies under the spec
    (scales included); the bf16 baseline when spec is None."""
    if spec is None:
        return float(feat * cache_dtype_bytes)
    bs, n_blocks, n_words = kv_layout(spec, feat)
    return float(n_words * 4 + n_blocks * 2)
