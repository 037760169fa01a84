"""Attention: GQA with RoPE and the (optionally k-bit) KV cache — port of the
dense subset of ``repro/models/attention.py``.

* prefill — ``flash_attention``: q in chunks, an online softmax over KV
  chunks inside each, with exact static KV ranges for causal masking.
* decode — ``decode_attention_partial`` computes flash-decoding partials
  (max, denominator, weighted values) over the cache and
  ``combine_partials`` merges them.

The math is plain PyTorch that mirrors the reference's masked online
softmax (scores and sums in f32, probabilities rounded to the value dtype
before the value product), not ``scaled_dot_product_attention``.

A cache is {"k","v": [B, S_c, K, Dh], "pos": [S_c]}, where ``pos[slot]``
is the absolute position in that slot (-1 = empty); the continuous-batching
pool keeps one position array a row, ``pos`` [B, S_c] (``per_slot=True``).
A decode position is an int32 tensor in device memory: 0-d (every row at
one position, the static Engine) or [B] (a position a row, -1 = idle row),
so a step captured as a CUDA graph reads it at replay.  A k-bit cache swaps
k/v for {"k_packed","k_scales","v_packed","v_scales"} (layout in
``kernels/kv_dequant.py``): writes quantize the new token
(append-quantize); a decode read goes through
``kernels/kv_attention.decode_attention_packed`` — on the card one launch of
the fused kernel a layer that dequantizes the cache in registers, on the
CPU the dequant and the partials below.  Decode writes update the cache
tensors **in place** (the reference returns new arrays).

``prefill_chunk_attention`` is one chunk of a chunked prefill, bitwise
equal to ``flash_attention``'s rows for a prompt within one KV chunk.

Not in this slice: sliding-window ring caches, the sharded combine and the
paged cache.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import kv_attention, kv_dequant
from repro_torch.models.layers import apply_rope, dense, rmsnorm

NEG_INF = -1e30
#: query rows a piece of ``flash_attention`` and ``prefill_chunk_attention``
#: (keys go in multiples of it too): a row's products then have the same
#: shapes however many rows follow it, so on the card a prompt padded to a
#: bucket, the same prompt at its exact length and its chunks (starting at
#: multiples of this) give the same rows bit for bit
Q_PIECE = 128
#: keys a step of ``flash_attention``'s online softmax: a chunked prefill
#: (``prefill_chunk_attention``) equals the plain one bit for bit only while
#: the whole bucketed prompt fits one such chunk
KV_CHUNK = 1024


def _is_quantized_cache(cache: dict) -> bool:
    return "k_packed" in cache


def init_attention(init, cfg) -> dict:
    D, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init.dense(D, H * Dh, bias=cfg.qkv_bias),
        "wk": init.dense(D, K * Dh, bias=cfg.qkv_bias),
        "wv": init.dense(D, K * Dh, bias=cfg.qkv_bias),
        "wo": init.dense(H * Dh, D, scale=(H * Dh) ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": init.zeros((Dh,))}
        p["k_norm"] = {"scale": init.zeros((Dh,))}
    return p


def project_qkv(params, x, cfg, positions):
    """x [B,S,D] -> q [B,S,H,Dh], k,v [B,S,K,Dh] with RoPE applied."""
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mm = cfg.matmul_mode
    q = dense(params["wq"], x, mode=mm).reshape(B, S, H, Dh)
    k = dense(params["wk"], x, mode=mm).reshape(B, S, K, Dh)
    v = dense(params["wv"], x, mode=mm).reshape(B, S, K, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"]["scale"])
        k = rmsnorm(k, params["k_norm"]["scale"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _masked_softmax_pieces(s, valid):
    """(m, p, l) of the reference's masked online softmax; valid broadcasts."""
    s = torch.where(valid, s, NEG_INF)
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF / 2)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p, p.sum(dim=-1)


def _chunk_attend(q, k, v, q_pos, k_pos, *, causal, window, cap, sm_scale, n_keys=None):
    """One (q-chunk, kv-chunk) tile.  q [B,cq,K,G,Dh]; k,v [B,ck,K,Dh];
    returns (m [B,K,G,cq], l, p@v [B,K,G,cq,Dh]) in f32.  Keys at positions
    >= ``n_keys`` (zero padding) are masked."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32), k.to(torch.float32))
    s = s * sm_scale
    if cap:
        s = cap * torch.tanh(s / cap)
    valid = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    if n_keys is not None:
        valid &= k_pos[None, :] < n_keys
    m, p, l = _masked_softmax_pieces(s, valid)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    return m, l, pv


def _pad_rows(x, n: int):
    """x [B, S, ...] with zero rows appended along dim 1 up to n."""
    if x.shape[1] == n:
        return x
    pad = torch.zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def flash_attention(q, k, v, *, q_start: int = 0, causal: bool = True, window: int = 0,
                    cap: float = 0.0, chunk_kv: int = KV_CHUNK):
    """Chunked online-softmax attention.  q [B,Sq,H,Dh]; k,v [B,Skv,K,Dh]
    (GQA: H = K*G); q_start is the absolute position of q[0].

    Query rows go in pieces of ``Q_PIECE`` and keys in multiples of it,
    zero rows appended past either end (masked, and cut from the output);
    under a causal mask a piece reads the keys up to its own end.  So a
    piece's products have the same shapes whatever rows follow it: a
    prompt at its exact length and the same prompt padded to a bucket give
    the same rows, as do a prompt and its chunks (``prefill_chunk_attention``)."""
    B, Sq, H, Dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    sm_scale = Dh**-0.5
    Sq_p, Skv_p = _round_up(Sq, Q_PIECE), _round_up(Skv, Q_PIECE)
    qg = _pad_rows(q, Sq_p).reshape(B, Sq_p, K, G, Dh)
    k, v = _pad_rows(k, Skv_p), _pad_rows(v, Skv_p)
    outs = []
    for qs in range(0, Sq_p, Q_PIECE):
        q_pos = q_start + qs + torch.arange(Q_PIECE, device=q.device)
        hi = min(Skv_p, q_start + qs + Q_PIECE) if causal else Skv_p
        lo = max(0, q_start + qs - window + 1) if window else 0
        lo = (lo // chunk_kv) * chunk_kv
        if hi <= lo:
            outs.append(torch.zeros((B, Q_PIECE, K, G, Dh), dtype=q.dtype, device=q.device))
            continue
        m = torch.full((B, K, G, Q_PIECE), NEG_INF / 2, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, K, G, Q_PIECE), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, G, Q_PIECE, Dh), dtype=torch.float32, device=q.device)
        for ks in range(lo, hi, chunk_kv):
            ke = min(ks + chunk_kv, hi)
            k_pos = torch.arange(ks, ke, device=q.device)
            m_c, l_c, pv_c = _chunk_attend(qg[:, qs:qs + Q_PIECE], k[:, ks:ke], v[:, ks:ke],
                                           q_pos, k_pos, causal=causal, window=window, cap=cap,
                                           sm_scale=sm_scale, n_keys=Skv)
            m_new = torch.maximum(m, m_c)
            a = torch.exp(m - m_new)
            b = torch.exp(m_c - m_new)
            l = l * a + l_c * b
            acc = acc * a[..., None] + pv_c * b[..., None]
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :Sq].reshape(B, Sq, H, Dh)


def prefill_chunk_attention(q, k, v, q_pos: int, *, cap: float = 0.0):
    """One chunk of a chunked prefill: C query rows at absolute positions
    q_pos .. q_pos + C - 1 attend causally over a dense workspace k, v
    [B, Skv, K, Dh] that already holds every position up to the chunk's
    last.  For Skv <= ``KV_CHUNK`` (one KV chunk of ``flash_attention``)
    this is ``flash_attention``'s rows bit for bit where the two run the
    same shapes (on the card: q_pos a multiple of ``Q_PIECE``): the online
    softmax then runs one step whose combine is exact (m = m_c, a = 0,
    b = 1), and both read a piece's keys up to the piece's end."""
    B, C, H, Dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    C_p, Skv_p = _round_up(C, Q_PIECE), _round_up(Skv, Q_PIECE)
    qg = _pad_rows(q, C_p).reshape(B, C_p, K, G, Dh)
    k, v = _pad_rows(k, Skv_p), _pad_rows(v, Skv_p)
    outs = []
    for qs in range(0, C_p, Q_PIECE):
        hi = min(Skv_p, q_pos + qs + Q_PIECE)
        q_rows = q_pos + qs + torch.arange(Q_PIECE, device=q.device)
        k_pos = torch.arange(hi, device=q.device)
        _, l, pv = _chunk_attend(qg[:, qs:qs + Q_PIECE], k[:, :hi], v[:, :hi], q_rows, k_pos,
                                 causal=True, window=0, cap=cap, sm_scale=Dh**-0.5, n_keys=Skv)
        o = pv / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :C].reshape(B, C, H, Dh)


def init_kv_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *, kvq=None,
                  per_slot: bool = False, device=None) -> dict:
    """An empty cache (pos = -1 everywhere); a KVQuantSpec ``kvq`` swaps the
    dense k/v for packed codes + scales.  ``per_slot`` gives each row its
    own position array [B, S_c] (continuous batching: rows hold independent
    requests at independent positions)."""
    K, Dh = cfg.n_kv_heads, cfg.head_dim
    pos_shape = (batch, cache_len) if per_slot else (cache_len,)
    pos = torch.full(pos_shape, -1, dtype=torch.int32, device=device)
    if kvq is not None:
        _, n_blocks, n_words = kv_dequant.kv_layout(kvq, K * Dh)
        return {
            "k_packed": torch.zeros((batch, cache_len, n_words), dtype=torch.int32, device=device),
            "k_scales": torch.zeros((batch, cache_len, n_blocks), dtype=torch.bfloat16, device=device),
            "v_packed": torch.zeros((batch, cache_len, n_words), dtype=torch.int32, device=device),
            "v_scales": torch.zeros((batch, cache_len, n_blocks), dtype=torch.bfloat16, device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros((batch, cache_len, K, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, K, Dh), dtype=dtype, device=device),
        "pos": pos,
    }


def _encoded(k, v, kvq):
    """(key, value) pairs of a k-bit cache for token rows k, v [..., K, Dh]."""
    feat = k.shape[-2] * k.shape[-1]
    kp, ks = kv_dequant.encode_rows(k.reshape(k.shape[:-2] + (feat,)), kvq)
    vp, vs = kv_dequant.encode_rows(v.reshape(v.shape[:-2] + (feat,)), kvq)
    return (("k_packed", kp), ("k_scales", ks), ("v_packed", vp), ("v_scales", vs))


def as_position(pos, device) -> torch.Tensor:
    """A decode position as an int32 tensor: a tensor as given (0-d or [B]),
    a Python int as a 0-d device fill (no host-to-device copy)."""
    if isinstance(pos, torch.Tensor):
        return pos if pos.dtype == torch.int32 else pos.to(torch.int32)
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def write_cache_decode(cache: dict, k_new, v_new, pos, *, kvq=None) -> dict:
    """Write one token's K/V [B, K, Dh] at absolute position ``pos``, in
    place; a k-bit cache gets the append-quantized rows.

    ``pos`` is a 0-d int32 tensor (every row at one position, over a shared
    [S_c] position array) or a [B] one over a per-slot [B, S_c] array.  A row
    with pos < 0 is idle: its write lands at a clamped slot with pos -1, an
    entry the attention mask treats as empty.  Indices stay on the device:
    no ``int()`` and no host copy, so the write can be captured in a graph."""
    pos = as_position(pos, k_new.device)
    S_c = cache["pos"].shape[-1]
    quantized = kvq is not None and _is_quantized_cache(cache)
    vals = (_encoded(k_new, v_new, kvq) if quantized else
            (("k", k_new.to(cache["k"].dtype)), ("v", v_new.to(cache["v"].dtype))))
    if pos.ndim == 0:
        if cache["pos"].ndim != 1:
            raise ValueError("a shared position needs a shared [S_c] position array")
        idx = pos.reshape(1).to(torch.int64)
        for key, val in vals:
            cache[key].index_copy_(1, idx, val[:, None])
        cache["pos"].index_copy_(0, idx, pos.reshape(1))
        return cache
    if cache["pos"].ndim != 2 or pos.shape[0] != cache["pos"].shape[0]:
        raise ValueError(f"positions {tuple(pos.shape)} need a per-slot position array, got "
                         f"{tuple(cache['pos'].shape)}")
    rows = torch.arange(pos.shape[0], device=pos.device)
    slot = torch.clamp(pos, 0, S_c - 1).to(torch.int64)
    for key, val in vals:
        cache[key].index_put_((rows, slot), val)
    cache["pos"].index_put_((rows, slot), pos)
    return cache


def write_cache_prefill(cache: dict, k_seq, v_seq, *, kvq=None) -> dict:
    """Write a prefilled sequence [B,S,K,Dh] into slots [0..S), in place."""
    S = k_seq.shape[1]
    if kvq is not None and _is_quantized_cache(cache):
        for key, val in _encoded(k_seq, v_seq, kvq):
            cache[key][:, :S] = val
    else:
        cache["k"][:, :S] = k_seq.to(cache["k"].dtype)
        cache["v"][:, :S] = v_seq.to(cache["v"].dtype)
    cache["pos"][:S] = torch.arange(S, dtype=torch.int32, device=cache["pos"].device)
    return cache


def decode_attention_partial(q, k_cache, v_cache, pos_arr, pos, *, cap=0.0, window=0):
    """Flash-decoding partials over a cache.  q [B,H,Dh]; k_cache, v_cache
    [B,S,K,Dh]; pos_arr [S] absolute positions (-1 empty) with a shared
    position ``pos`` (int or 0-d), or pos_arr [B,S] with ``pos`` [B]: each
    row masks against its own position, and a row with pos < 0 sees no
    valid slot (l = 0, a zero output).  Returns (m, l, pv): [B,K,G],
    [B,K,G], [B,K,G,Dh]."""
    B, H, Dh = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * (Dh**-0.5)
    if cap:
        s = cap * torch.tanh(s / cap)
    pos_q = pos[:, None] if isinstance(pos, torch.Tensor) and pos.ndim else pos
    valid = (pos_arr >= 0) & (pos_arr <= pos_q)
    if window:
        valid &= pos_arr > pos_q - window
    vmask = valid[None, None, None, :] if valid.ndim == 1 else valid[:, None, None, :]
    m, p, l = _masked_softmax_pieces(s, vmask)
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(torch.float32),
                      v_cache.to(torch.float32))
    return m, l, pv


def combine_partials(m, l, pv):
    """Merge flash-decoding partials of one (unsharded) cache."""
    return pv / torch.clamp(l, min=1e-30)[..., None]


def decode_attention(q, cache, pos, *, cap=0.0, window=0, kvq=None):
    """Single-token attention against a cache at ``pos`` (an int, a 0-d or a
    [B] tensor, as ``write_cache_decode`` takes it).  A packed cache is read
    by ``kv_attention.decode_attention_packed`` (the fused kernel on the
    card, which raises on a window)."""
    if kvq is not None and _is_quantized_cache(cache):
        return kv_attention.decode_attention_packed(q, cache, pos, kvq, cap=cap, window=window)
    B, H, Dh = q.shape
    m, l, pv = decode_attention_partial(q, cache["k"], cache["v"], cache["pos"], pos,
                                        cap=cap, window=window)
    return combine_partials(m, l, pv).reshape(B, H, Dh).to(q.dtype)
