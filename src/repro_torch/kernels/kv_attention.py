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
            "v_scales": [B, S, NB] bf16, "pos": [S] int32 (-1 = empty)}
  out      [B, H, Dh]      bf16

It computes what the plain version, ``decode_attention_packed_plain``,
computes with the models' own functions (``kv_dequant.dequant_rows_ref``,
``attention.decode_attention_partial``, ``attention.combine_partials``), up
to the order of f32 sums: p is rounded to bf16 against the maximum over the
whole cache.  What bounds the kernel (bytes) and its design are noted in
its source.

``decode_attention_packed`` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; ``decode_attention_packed_cuda.launches``
counts the launches.  Both take a logit soft-cap; only the plain version
takes a sliding window (the port builds no windowed model yet).  Neither
takes a bf16 cache or bits other than 4 and 8.  The kernel takes head dims
32, 64 and 128, up to 8 query heads a KV head, scale blocks of whole words,
and as many slots as its shared memory holds (about 39 K at kv4 and kv8
with Qwen2-7B's 7 query heads a KV head; past that the launch fails).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels.kv_dequant import KVQuantSpec, dequant_rows_ref, kv_codebook, kv_layout

KERNEL_BITS = (4, 8)
KERNEL_HEAD_DIMS = (32, 64, 128)
#: query heads a KV head that csrc/kv_decode_attention.cu takes (the mma's n)
MAX_G = 8


def _check(q: torch.Tensor, cache: dict, spec):
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
    S, W = kp.shape[1:]
    feat = W * packing.codes_per_word(spec.bits)
    if kp.shape[0] != B or feat % Dh or H % (feat // Dh):
        raise ValueError(f"decode_attention_packed: q {tuple(q.shape)} does not fit a cache "
                         f"of {W} words a slot at {spec.bits} bits")
    for key in ("v_packed", "k_scales", "v_scales"):
        if cache[key].shape[:2] != (B, S):
            raise ValueError(f"decode_attention_packed: {key} {tuple(cache[key].shape)}")
    if cache["pos"].shape != (S,):
        raise ValueError(f"decode_attention_packed: pos {tuple(cache['pos'].shape)}, S = {S}")
    return B, H, Dh, S, feat


def decode_attention_packed_plain(q: torch.Tensor, cache: dict, pos: int, spec: KVQuantSpec,
                                  *, cap: float = 0.0, window: int = 0) -> torch.Tensor:
    """The plain version: the cache dequantized to bf16 by the KV dequant's
    plain version, then the models' masked softmax partials and combine."""
    from repro_torch.models import attention  # models.attention imports this module

    B, H, Dh, S, feat = _check(q, cache, spec)
    shape = (B, S, feat // Dh, Dh)
    k = dequant_rows_ref(cache["k_packed"], cache["k_scales"], spec, feat).reshape(shape)
    v = dequant_rows_ref(cache["v_packed"], cache["v_scales"], spec, feat).reshape(shape)
    m, l, pv = attention.decode_attention_partial(q, k, v, cache["pos"], pos, cap=cap,
                                                  window=window)
    return attention.combine_partials(m, l, pv).reshape(B, H, Dh).to(q.dtype)


def _lib():
    lib = _build.load("kv_decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.kv_decode_attention.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                                            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.kv_decode_attention.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def decode_attention_packed_cuda(q: torch.Tensor, cache: dict, pos: int, spec: KVQuantSpec,
                                 *, cap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Launch the kernel on a CUDA cache (one launch a layer); counts
    launches in ``.launches``."""
    if window:
        raise ValueError(f"decode_attention_packed_cuda takes no sliding window, got {window}")
    B, H, Dh, S, feat = _check(q, cache, spec)
    K = feat // Dh
    G = H // K
    bs, n_blocks, n_words = kv_layout(spec, feat)
    cpw = packing.codes_per_word(spec.bits)
    if Dh not in KERNEL_HEAD_DIMS or G > MAX_G or bs % cpw:
        raise ValueError(f"decode_attention_packed_cuda takes head dims {KERNEL_HEAD_DIMS}, up "
                         f"to {MAX_G} query heads a KV head and scale blocks of whole words: "
                         f"got Dh {Dh}, G {G}, block {bs} at {cpw} codes a word")
    if q.dtype != torch.bfloat16 or not q.is_contiguous() or q.device.type != "cuda":
        raise ValueError("decode_attention_packed_cuda takes q as contiguous bf16 on CUDA")
    for key, dt, align in (("k_packed", torch.int32, 16), ("v_packed", torch.int32, 16),
                           ("k_scales", torch.bfloat16, 4), ("v_scales", torch.bfloat16, 4),
                           ("pos", torch.int32, 4)):
        t = cache[key]
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device or t.data_ptr() % align:
            raise ValueError(f"decode_attention_packed_cuda: {key} must be contiguous {dt} on "
                             f"{q.device}, {align}-byte aligned")
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
            cache["pos"].data_ptr(), out.data_ptr(), B, H, K, S, n_words, n_blocks, bs,
            spec.bits, Dh, int(pos), float(Dh ** -0.5), float(cap), stream)
    _build.check(status, "kv_decode_attention")
    decode_attention_packed_cuda.launches += 1
    return out


decode_attention_packed_cuda.launches = 0


def decode_attention_packed(q: torch.Tensor, cache: dict, pos: int, spec: KVQuantSpec, *,
                            cap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Single-token attention of q [B, H, Dh] over a packed k-bit cache:
    the fused kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return decode_attention_packed_cuda(q, cache, pos, spec, cap=cap, window=window)
    if q.device.type == "cpu":
        return decode_attention_packed_plain(q, cache, pos, spec, cap=cap, window=window)
    raise ValueError(f"decode_attention_packed runs on cuda or cpu tensors, not {q.device}")
