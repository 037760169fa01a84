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
is the absolute position in that slot (-1 = empty).  A k-bit cache swaps
k/v for {"k_packed","k_scales","v_packed","v_scales"} (layout in
``kernels/kv_dequant.py``): writes quantize the new token
(append-quantize); a decode read goes through
``kernels/kv_attention.decode_attention_packed`` — on the card one launch of
the fused kernel a layer that dequantizes the cache in registers, on the
CPU the dequant and the partials below.  Decode writes update the cache
tensors **in place** (the reference returns new arrays).

Not in this slice: sliding-window ring caches, per-row position vectors
(continuous batching), the sharded combine and the paged cache.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import kv_attention, kv_dequant
from repro_torch.models.layers import apply_rope, dense, rmsnorm

NEG_INF = -1e30


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


def _chunk_attend(q, k, v, q_pos, k_pos, *, causal, window, cap, sm_scale):
    """One (q-chunk, kv-chunk) tile.  q [B,cq,K,G,Dh]; k,v [B,ck,K,Dh];
    returns (m [B,K,G,cq], l, p@v [B,K,G,cq,Dh]) in f32."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32), k.to(torch.float32))
    s = s * sm_scale
    if cap:
        s = cap * torch.tanh(s / cap)
    valid = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    m, p, l = _masked_softmax_pieces(s, valid)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    return m, l, pv


def flash_attention(q, k, v, *, q_start: int = 0, causal: bool = True, window: int = 0,
                    cap: float = 0.0, chunk_q: int = 512, chunk_kv: int = 1024):
    """Chunked online-softmax attention.  q [B,Sq,H,Dh]; k,v [B,Skv,K,Dh]
    (GQA: H = K*G); q_start is the absolute position of q[0]."""
    B, Sq, H, Dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    sm_scale = Dh**-0.5
    chunk_q = min(chunk_q, Sq)
    chunk_kv = min(chunk_kv, Skv)
    qg = q.reshape(B, Sq, K, G, Dh)
    outs = []
    for qs in range(0, Sq, chunk_q):
        qe = min(Sq, qs + chunk_q)
        cq = qe - qs
        q_pos = q_start + qs + torch.arange(cq, device=q.device)
        hi = min(Skv, q_start + qe) if causal else Skv
        lo = max(0, q_start + qs - window + 1) if window else 0
        lo = (lo // chunk_kv) * chunk_kv
        hi = min(Skv, -(-hi // chunk_kv) * chunk_kv)
        if hi <= lo:
            outs.append(torch.zeros((B, cq, K, G, Dh), dtype=q.dtype, device=q.device))
            continue
        m = torch.full((B, K, G, cq), NEG_INF / 2, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, K, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, G, cq, Dh), dtype=torch.float32, device=q.device)
        for ks in range(lo, hi, chunk_kv):
            ke = min(ks + chunk_kv, hi)
            k_pos = torch.arange(ks, ke, device=q.device)
            m_c, l_c, pv_c = _chunk_attend(qg[:, qs:qe], k[:, ks:ke], v[:, ks:ke], q_pos,
                                           k_pos, causal=causal, window=window, cap=cap,
                                           sm_scale=sm_scale)
            m_new = torch.maximum(m, m_c)
            a = torch.exp(m - m_new)
            b = torch.exp(m_c - m_new)
            l = l * a + l_c * b
            acc = acc * a[..., None] + pv_c * b[..., None]
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, Sq, H, Dh)


def init_kv_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *, kvq=None,
                  device=None) -> dict:
    """An empty cache (pos = -1 everywhere); a KVQuantSpec ``kvq`` swaps the
    dense k/v for packed codes + scales."""
    K, Dh = cfg.n_kv_heads, cfg.head_dim
    pos = torch.full((cache_len,), -1, dtype=torch.int32, device=device)
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


def write_cache_decode(cache: dict, k_new, v_new, pos: int, *, kvq=None) -> dict:
    """Write one token's K/V [B, K, Dh] at absolute position ``pos`` (shared
    by all rows), in place; a k-bit cache gets the append-quantized rows."""
    pos = int(pos)
    if kvq is not None and _is_quantized_cache(cache):
        for key, val in _encoded(k_new, v_new, kvq):
            cache[key][:, pos] = val
    else:
        cache["k"][:, pos] = k_new.to(cache["k"].dtype)
        cache["v"][:, pos] = v_new.to(cache["v"].dtype)
    cache["pos"][pos: pos + 1].fill_(pos)   # a device fill, no host-to-device copy
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
    [B,S,K,Dh]; pos_arr [S] absolute positions (-1 empty).  Returns (m, l,
    pv): [B,K,G], [B,K,G], [B,K,G,Dh]."""
    B, H, Dh = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * (Dh**-0.5)
    if cap:
        s = cap * torch.tanh(s / cap)
    valid = (pos_arr >= 0) & (pos_arr <= pos)
    if window:
        valid &= pos_arr > pos - window
    m, p, l = _masked_softmax_pieces(s, valid[None, None, None, :])
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(torch.float32),
                      v_cache.to(torch.float32))
    return m, l, pv


def combine_partials(m, l, pv):
    """Merge flash-decoding partials of one (unsharded) cache."""
    return pv / torch.clamp(l, min=1e-30)[..., None]


def decode_attention(q, cache, pos: int, *, cap=0.0, window=0, kvq=None):
    """Single-token attention against a cache.  A packed cache is read by
    ``kv_attention.decode_attention_packed`` (the fused kernel on the card,
    which raises on a window)."""
    if kvq is not None and _is_quantized_cache(cache):
        return kv_attention.decode_attention_packed(q, cache, pos, kvq, cap=cap, window=window)
    B, H, Dh = q.shape
    m, l, pv = decode_attention_partial(q, cache["k"], cache["v"], cache["pos"], pos,
                                        cap=cap, window=window)
    return combine_partials(m, l, pv).reshape(B, H, Dh).to(q.dtype)
