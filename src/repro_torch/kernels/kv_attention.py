"""Decode attention over the packed k-bit KV cache — the decode read of
``repro/models/attention.py`` (``dequant_cache_kv``,
``decode_attention_partial``, ``combine_partials``) fused with the KV
dequant ``repro/kernels/kv_dequant.py``.

On the card one launch of ``csrc/kv_decode_attention.cu`` a layer replaces,
on the decode path, the TPU kernel ``dequant_rows_pallas``
(src/repro/kernels/kv_dequant.py:159, call :179) and the attention that
reads its output; bf16 K and V never land in device memory:

  q        [B, H, Dh]      bf16, H = K * G query heads over K KV heads
  cache    {"k_packed", "v_packed": [B, S, W] int32, "k_scales",
            "v_scales": [B, S, NB] bf16, "pos": [S] or [B, S] int32
            (-1 = empty)}
  pos      int32, 0-d (one position for every row, over "pos" [S]) or [B]
           (a position a row over "pos" [B, S]; pos < 0 = an idle row,
           whose output is exactly zero); read by the kernel from device
           memory, so a captured graph reads each replay's positions
  out      [B, H, Dh]      bf16

A paged cache (``serving/pages.py``) passes ``page_map`` [B, P] int32 (each
row's page ids in table order) and ``page_size`` ps: its leaves are then
page-major, [n_pages, ps, W], [n_pages, ps, NB] and "pos" [n_pages, ps],
the logical length is S = P * ps, and pos is [B].  The kernel reads slot t
of row b at row ``page_map[b, t // ps] * ps + t % ps`` of every leaf; the
plain version gathers the pages (``kv_dequant.gather_pages``) and runs its
unpaged body, so the two read the same values in the same order.

It computes what the plain version, ``decode_attention_packed_plain``,
computes with the models' own functions (``kv_dequant.dequant_rows_ref``,
``attention.decode_attention_partial``, ``attention.combine_partials``), up
to the order of f32 sums: p is rounded to bf16 against the maximum over the
whole cache.  What bounds the kernel (bytes) and its design are noted in
its source.

``decode_attention_packed`` routes by shapes alone.  On CUDA, where
``fused_takes`` says the kernel takes the call, one launch of the kernel;
elsewhere the routed read, ``decode_attention_packed_routed``: the layer's
K and V dequantized by one launch of ``csrc/kv_dequant.cu`` (through the
page map for a paged cache), then the models' masked partials and combine,
the reference's own read (src/repro/models/attention.py:533-545, :597-613).
For CPU tensors, the plain version.  ``decode_attention_packed_cuda``
counts the kernel's launches in ``.launches`` and raises, before any
launch, on every shape the rule routes.  The kernel takes head dims 32, 64
and 128, up to 8 query heads a KV head, scale blocks of whole words and as
many slots as its shared memory holds (39,808 at kv4 with Qwen2-7B's 7
query heads a KV head); ``fused_takes`` mirrors those refusals and reads no
device value, so the route is decided the same way inside a CUDA-graph
capture.  All three take a logit soft-cap; a sliding window goes to the
routed read on the card (h2o-danube-3's layers, gemma2's local ones: a
ring cache, whose slots are not in position order, masked by its stored
positions), and the kernel's wrapper raises on one.  None takes a bf16
cache or bits other than 4 and 8.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels.kv_dequant import (
    KVQuantSpec,
    dequant_kv,
    dequant_kv_plain,
    gather_pages,
    kv_codebook,
    kv_layout,
    kv_rows_read,
)
from repro_torch.utils import cost

KERNEL_BITS = (4, 8)
KERNEL_HEAD_DIMS = (32, 64, 128)
# csrc/kv_decode_attention.cu's constants: query heads a KV head (the mma's
# n), CTAs a (batch row, KV head), warps a CTA, shared memory a CTA may take
MAX_G = 8
CLUSTER = 8
WARPS = 4
MAX_SMEM = 232448
#: the kernel's grid takes at most this many batch rows and KV heads
MAX_GRID_YZ = 65535


def _smem_words(S: int, G: int, Dh: int, wph: int, sw: int, cap: int) -> int:
    """4-byte words of shared memory a CTA takes: the kernel's make_layout
    (csrc/kv_decode_attention.cu) with ``cap`` slots a round."""
    tpc = ((S + CLUSTER - 1) // CLUSTER + 15) // 16 * 16
    stage = cap * (wph + sw)
    k_words = (max(stage, WARPS * MAX_G * Dh) + 3) // 4 * 4
    v_words = (stage + 3) // 4 * 4
    o_p = 256 + 3 * MAX_G + WARPS * MAX_G + MAX_G * Dh + G * (tpc + 4)
    o_k = (o_p + (G * (tpc + 8) + 1) // 2 + 3) // 4 * 4
    return o_k + k_words + v_words


def fused_refusal(B: int, H: int, Dh: int, S: int, spec: KVQuantSpec, feat: int,
                  window: int = 0):
    """Why csrc/kv_decode_attention.cu does not take a call of q [B, H, Dh]
    over a packed cache of S slots (paged or not) and ``feat`` features a
    slot, or None where it does.  A pure function of shapes, mirroring the
    kernel's own refusals: a sliding window, bits, head dim, query heads a
    KV head, blocks that split a word, the grid, and its shared-memory
    layout, whose slots a round (the kernel's ``cap`` loop) shrink from a
    CTA's share to 16 before the kernel refuses, so it takes a cache where
    16 do fit."""
    if window:
        return f"decode_attention_packed_cuda takes no sliding window, got {window}"
    K = feat // Dh
    G = H // K
    bs, _, _ = kv_layout(spec, feat)
    cpw = packing.codes_per_word(spec.bits)
    if spec.bits not in KERNEL_BITS or Dh not in KERNEL_HEAD_DIMS or G > MAX_G or bs % cpw:
        return (f"decode_attention_packed_cuda takes kv4 or kv8, head dims {KERNEL_HEAD_DIMS}, "
                f"up to {MAX_G} query heads a KV head and scale blocks of whole words: got "
                f"{spec.bits} bits, Dh {Dh}, G {G}, block {bs} at {cpw} codes a word")
    if B > MAX_GRID_YZ or K > MAX_GRID_YZ:
        return (f"decode_attention_packed_cuda takes up to {MAX_GRID_YZ} batch rows and KV "
                f"heads, got {B} and {K}")
    # the scale blocks a head spans, at most, and the 4-byte words that hold them
    nbh = max((kh * Dh + Dh - 1) // bs - kh * Dh // bs + 1 for kh in range(K))
    words = _smem_words(S, G, Dh, Dh * spec.bits // 32, (nbh + 2) // 2, 16)
    if words * 4 > MAX_SMEM:
        return (f"decode_attention_packed_cuda: the scores of {S} slots at G {G}, Dh {Dh} "
                f"take {words * 4} bytes of shared memory a CTA, over {MAX_SMEM}")
    return None


def fused_takes(B: int, H: int, Dh: int, S: int, spec: KVQuantSpec, feat: int,
                window: int = 0) -> bool:
    """Whether the fused kernel takes the call (``fused_refusal`` is None)."""
    return fused_refusal(B, H, Dh, S, spec, feat, window) is None


def _check(q: torch.Tensor, cache: dict, spec, page_map=None, page_size=None):
    """(B, H, Dh, S, feat) of a call, or raise for what neither the kernel
    nor its plain version takes."""
    if spec is None or "k_packed" not in cache:
        raise ValueError("decode_attention_packed reads a packed k-bit cache, not a bf16 one")
    if spec.bits not in KERNEL_BITS:
        raise ValueError(f"decode_attention_packed takes kv4 or kv8, got {spec.bits} bits")
    if q.ndim != 3:
        raise ValueError(f"decode_attention_packed takes q [B, H, Dh], got {tuple(q.shape)}")
    B, H, Dh = q.shape
    kp = cache["k_packed"]
    lead, W = tuple(kp.shape[:2]), kp.shape[2]
    feat = W * packing.codes_per_word(spec.bits)
    if page_map is None:
        if page_size is not None:
            raise ValueError("decode_attention_packed: page_size without a page_map")
        S = lead[1]
        if lead[0] != B:
            raise ValueError(f"decode_attention_packed: q {tuple(q.shape)} over a cache of "
                             f"{lead[0]} rows")
        pos_shapes = ((S,), (B, S))
    else:
        ps = lead[1]
        if page_map.ndim != 2 or page_map.shape[0] != B or page_size != ps \
                or ps & (ps - 1):
            raise ValueError(f"decode_attention_packed: a page map [B, P] of {B} rows over "
                             f"pages of a power-of-two {ps} slots (page_size {page_size}), "
                             f"got {tuple(page_map.shape)}")
        S = page_map.shape[1] * ps
        pos_shapes = (lead,)
    if feat % Dh or H % (feat // Dh):
        raise ValueError(f"decode_attention_packed: q {tuple(q.shape)} does not fit a cache "
                         f"of {W} words a slot at {spec.bits} bits")
    for key in ("v_packed", "k_scales", "v_scales"):
        if tuple(cache[key].shape[:2]) != lead:
            raise ValueError(f"decode_attention_packed: {key} {tuple(cache[key].shape)}")
    if tuple(cache["pos"].shape) not in pos_shapes:
        raise ValueError(f"decode_attention_packed: pos {tuple(cache['pos'].shape)}, S = {S}")
    return B, H, Dh, S, feat


def _positions(pos, cache: dict, B: int, device, paged: bool = False) -> torch.Tensor:
    """The decode position as an int32 tensor that fits the cache's position
    array: 0-d over [S], [B] over [B, S] or over pages; an int becomes a
    0-d device fill."""
    from repro_torch.models import attention  # models.attention imports this module

    pos = attention.as_position(pos, device)
    want = () if cache["pos"].ndim == 1 and not paged else (B,)
    if tuple(pos.shape) != want:
        raise ValueError(f"decode_attention_packed: positions {tuple(pos.shape)} over a "
                         f"position array {tuple(cache['pos'].shape)}")
    return pos


def _read_dequantized(q, cache, pos, spec, dequant, *, cap, window, page_map, page_size):
    """The reference's read of a packed cache: K and V dequantized by
    ``dequant`` (rows, or pages through the map), then the models' masked
    softmax partials and combine."""
    from repro_torch.models import attention  # models.attention imports this module

    B, H, Dh, S, feat = _check(q, cache, spec, page_map, page_size)
    pos = _positions(pos, cache, B, q.device, page_map is not None)
    pos_arr = cache["pos"] if page_map is None else gather_pages(cache["pos"], page_map)
    shape = (B, S, feat // Dh, Dh)
    k, v = dequant(cache, spec, feat, page_map)
    m, l, pv = attention.decode_attention_partial(q, k.reshape(shape), v.reshape(shape),
                                                  pos_arr, pos, cap=cap, window=window)
    return attention.combine_partials(m, l, pv).reshape(B, H, Dh).to(q.dtype)


def decode_attention_packed_plain(q: torch.Tensor, cache: dict, pos, spec: KVQuantSpec,
                                  *, cap: float = 0.0, window: int = 0, page_map=None,
                                  page_size=None) -> torch.Tensor:
    """The plain version: the cache (a paged one gathered into rows first)
    dequantized to bf16 by the KV dequant's plain version, then the models'
    masked softmax partials and combine."""
    return _read_dequantized(q, cache, pos, spec, dequant_kv_plain, cap=cap, window=window,
                             page_map=page_map, page_size=page_size)


def decode_attention_packed_routed(q: torch.Tensor, cache: dict, pos, spec: KVQuantSpec,
                                   *, cap: float = 0.0, window: int = 0, page_map=None,
                                   page_size=None) -> torch.Tensor:
    """The routed read, for the shapes the fused kernel does not take: the
    plain version's composition with the layer's K and V dequantized by
    ``kv_dequant.dequant_kv`` (one launch of csrc/kv_dequant.cu for CUDA
    tensors, reading a paged cache through its map; the plain dequant for
    CPU tensors, so there the two are one computation)."""
    return _read_dequantized(q, cache, pos, spec, dequant_kv, cap=cap, window=window,
                             page_map=page_map, page_size=page_size)


def _lib():
    lib = _build.load("kv_decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.kv_decode_attention.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                                            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.kv_decode_attention.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def decode_attention_packed_cuda(q: torch.Tensor, cache: dict, pos, spec: KVQuantSpec,
                                 *, cap: float = 0.0, window: int = 0, page_map=None,
                                 page_size=None) -> torch.Tensor:
    """Launch the kernel on a CUDA cache, paged or not (one launch a layer);
    counts launches in ``.launches``."""
    B, H, Dh, S, feat = _check(q, cache, spec, page_map, page_size)
    paged = page_map is not None
    pos = _positions(pos, cache, B, q.device, paged)
    K = feat // Dh
    bs, n_blocks, n_words = kv_layout(spec, feat)
    refusal = fused_refusal(B, H, Dh, S, spec, feat, window)
    if refusal:
        raise ValueError(refusal)
    if q.dtype != torch.bfloat16 or not q.is_contiguous() or q.device.type != "cuda":
        raise ValueError("decode_attention_packed_cuda takes q as contiguous bf16 on CUDA")
    for key, dt, align in (("k_packed", torch.int32, 16), ("v_packed", torch.int32, 16),
                           ("k_scales", torch.bfloat16, 4), ("v_scales", torch.bfloat16, 4),
                           ("pos", torch.int32, 4)):
        t = cache[key]
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device or t.data_ptr() % align:
            raise ValueError(f"decode_attention_packed_cuda: {key} must be contiguous {dt} on "
                             f"{q.device}, {align}-byte aligned")
    if pos.dtype != torch.int32 or pos.device != q.device or not pos.is_contiguous():
        raise ValueError(f"decode_attention_packed_cuda: positions must be contiguous int32 on "
                         f"{q.device}")
    if paged and (page_map.dtype != torch.int32 or page_map.device != q.device
                  or not page_map.is_contiguous()):
        raise ValueError(f"decode_attention_packed_cuda: the page map must be contiguous int32 "
                         f"on {q.device}")
    for key, n in (("k_packed", n_words), ("v_packed", n_words), ("k_scales", n_blocks),
                   ("v_scales", n_blocks)):
        if cache[key].shape[2] != n:
            raise ValueError(f"decode_attention_packed_cuda: {key} rows of {n} expected for "
                             f"{spec}, got {tuple(cache[key].shape)}")
    codebook = kv_codebook(spec, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _lib().kv_decode_attention(
            q.data_ptr(), cache["k_packed"].data_ptr(), cache["k_scales"].data_ptr(),
            cache["v_packed"].data_ptr(), cache["v_scales"].data_ptr(), codebook.data_ptr(),
            cache["pos"].data_ptr(), pos.data_ptr(), page_map.data_ptr() if paged else None,
            out.data_ptr(), B, H, K, S, n_words, n_blocks, bs, spec.bits, Dh,
            1 if pos.ndim else 0, -1 if paged else (S if cache["pos"].ndim == 2 else 0),
            page_map.shape[1] if paged else 0, page_size if paged else 0,
            float(Dh ** -0.5), float(cap), stream)
    _build.check(status, "kv_decode_attention")
    decode_attention_packed_cuda.launches += 1
    return out


decode_attention_packed_cuda.launches = 0


def _fused_work(q, cache, pos, spec, *, cap=0.0, window=0, page_map=None,
                page_size=None) -> dict:
    """B2.1's charge: q·kᵀ and p·v over every slot (masked ones too, as the
    reference multiplies them), a FLOP a K and V value dequantized and a
    FLOP a score; K and V as stored, the positions, q and the output."""
    B, H, Dh, S, feat = _check(q, cache, spec, page_map, page_size)
    dot, flops = cost.attention_work(1, H, Dh, S, B)
    _, read = kv_rows_read(cache, spec, feat, page_map)
    return dict(flops=flops + 2 * B * S * feat, dot_flops=dot,
                hbm_bytes=read + 4 * B * S + 2 * cost.nbytes(q))


@cost.unit(_fused_work)
def _fused_read(q, cache, pos, spec, **kw) -> torch.Tensor:
    """A read the fused kernel takes: the kernel on CUDA, the plain version
    on the CPU (one charged unit, so it costs the same on both)."""
    if q.device.type == "cuda":
        return decode_attention_packed_cuda(q, cache, pos, spec, **kw)
    return decode_attention_packed_plain(q, cache, pos, spec, **kw)


def decode_attention_packed(q: torch.Tensor, cache: dict, pos, spec: KVQuantSpec, *,
                            cap: float = 0.0, window: int = 0, page_map=None,
                            page_size=None) -> torch.Tensor:
    """Single-token attention of q [B, H, Dh] over a packed k-bit cache,
    paged or not: for CUDA tensors the fused kernel where ``fused_takes``
    says it takes the shapes, else the routed read; the plain version for
    CPU tensors."""
    kw = dict(cap=cap, window=window, page_map=page_map, page_size=page_size)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode_attention_packed runs on cuda or cpu tensors, not {q.device}")
    B, H, Dh, S, feat = _check(q, cache, spec, page_map, page_size)
    if fused_takes(B, H, Dh, S, spec, feat, window):
        return _fused_read(q, cache, pos, spec, **kw)
    if q.device.type == "cuda":
        return decode_attention_packed_routed(q, cache, pos, spec, **kw)
    return decode_attention_packed_plain(q, cache, pos, spec, **kw)
