"""Decoder-only LM assembled from blocks.py: init, loss, prefill, decode —
port of the dense path of ``repro/models/lm.py``.

The parameter tree has the reference's keys (``embed``, ``stack``,
``final_norm``, ``lm_head`` when untied), so a reference tree carries
across with ``interop.params_from_reference``.  Decode updates the caches
in place; its position lives in device memory (an int is accepted and
filled on the device once), so a step can be captured as a CUDA graph.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.qtensor import QuantizedTensor, dequantize_tensor
from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks
from repro_torch.models.layers import Init, linear, matmul_rounded, norm, softcap


def init_params(cfg, *, seed: int = 0, device=None, dtype=torch.float32) -> dict:
    """Seeded random parameters on ``device`` (CUDA by default), weights in
    ``dtype``, norm scales and biases f32 — the reference's init scales,
    drawn from a ``torch.Generator`` (different numbers from jax.random)."""
    init = Init(seed, resolve_device(device), dtype)
    p = {
        "embed": init.normal((cfg.vocab_size, cfg.d_model), 0.02),
        "stack": blocks.init_stack(init, cfg),
        "final_norm": init.norm(cfg.d_model, cfg.norm_type),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init.normal((cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5)
    return p


def count_params(cfg, active_only: bool = False) -> int:
    """Exact parameter count of the implemented (dense) model."""
    shapes = init_params(cfg, device="meta")

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(count(v) for v in tree)
        return math.prod(tree.shape)

    return count(shapes)


def head_matrix(params):
    """[V, D] output projection (tied embedding or lm_head; maybe quantized)."""
    return params.get("lm_head", params["embed"])


def logits_from_hidden(params, h, cfg):
    """h [..., D] -> logits [..., V]."""
    w = head_matrix(params)
    if isinstance(w, QuantizedTensor):
        out = linear(h, w, mode=cfg.matmul_mode)
    else:
        out = matmul_rounded(h, w)
    return softcap(out, cfg.final_logit_softcap)


def embed_inputs(params, tokens, cfg):
    emb = params["embed"]
    if isinstance(emb, QuantizedTensor):
        emb = dequantize_tensor(emb)
    return emb.to(torch.bfloat16)[tokens]


def backbone_seq(params, tokens, cfg, *, write_cache=False, cache_len=None):
    x = embed_inputs(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, caches = blocks.apply_stack_seq(params["stack"], x, cfg, positions=positions,
                                       cache_len=cache_len, write_cache=write_cache)
    return norm(params["final_norm"], x, cfg.norm_type), caches


def backbone_chunk(params, tokens, workspace, chunk_start: int, cfg):
    """One chunk of a chunked prefill: the backbone over C consecutive
    prompt rows from absolute position ``chunk_start``, against a dense bf16
    ``workspace`` (init_caches of the kv16 twin config, batch 1, the bucket
    length) that holds every earlier chunk's K/V and is updated in place.
    Row-wise the math is ``backbone_seq``'s, and the chunk attention is
    ``flash_attention``'s (``attention.prefill_chunk_attention``), so the
    final chunk's rows match a plain prefill's.  Returns the normed hidden
    [B, C, D]."""
    x = embed_inputs(params, tokens, cfg)
    x, _ = blocks.apply_stack_prefill_chunk(params["stack"], x, workspace, chunk_start, cfg)
    return norm(params["final_norm"], x, cfg.norm_type)


def loss_fn(params, tokens, labels, cfg, *, loss_chunk: int = 512):
    """Mean next-token cross entropy over labels >= 0, logits formed per
    sequence chunk (the tail past a whole number of chunks is dropped, as
    in the reference)."""
    h, _ = backbone_seq(params, tokens, cfg)
    B, S, D = h.shape
    loss_chunk = min(loss_chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // loss_chunk):
        sl = slice(c * loss_chunk, (c + 1) * loss_chunk)
        logits = logits_from_hidden(params, h[:, sl], cfg).to(torch.float32)
        y = labels[:, sl]
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, torch.clamp(y, min=0)[..., None].long())[..., 0]
        mask = (y >= 0).to(torch.float32)
        tot = tot + torch.sum((lse - ll) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0)


def prefill(params, tokens, cfg, *, cache_len=None):
    """Process a prompt; returns (last-token logits, caches).  ``cache_len``
    reserves decode room (defaults to the prompt length)."""
    h, caches = backbone_seq(params, tokens, cfg, write_cache=True, cache_len=cache_len)
    return logits_from_hidden(params, h[:, -1], cfg), caches


def decode_step(params, token, caches, pos, cfg):
    """One decoding step: token [B] at ``pos``: an int or a 0-d int32 tensor
    (every row at one position, over shared caches) or a [B] one (a
    position a row over per-slot caches, -1 = idle row).  Returns (logits
    [B, V], caches), the caches updated in place.  Nothing here reads a
    device value on the host, so the step can be captured as a CUDA graph."""
    x = embed_inputs(params, token, cfg)
    pos = attention.as_position(pos, x.device)
    x, caches = blocks.apply_stack_decode(params["stack"], x, caches, pos, cfg)
    x = norm(params["final_norm"], x, cfg.norm_type)
    return logits_from_hidden(params, x, cfg), caches


def init_caches(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
                per_slot: bool = False, device=None):
    """Empty decode caches; packed k-bit leaves when cfg.kv_bits < 16;
    ``per_slot`` gives each row its own position array (the slot pool)."""
    return blocks.init_stack_cache(cfg, batch, cache_len, dtype, per_slot=per_slot,
                                   device=resolve_device(device))
