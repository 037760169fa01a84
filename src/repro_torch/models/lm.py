"""Decoder-only LM assembled from blocks.py: init, loss, prefill, decode —
port of the decoder path of ``repro/models/lm.py`` (llama-style stacks,
sliding windows, gemma2's local/global period and soft-caps, mixture-of-
experts FFNs, Mamba-2 SSM layers and jamba's hybrid period); the
encoder-decoder is ``models/seq2seq.py``, built from the same blocks.

The parameter tree has the reference's keys (``embed``, ``stack``,
``final_norm``, ``lm_head`` when untied), so a reference tree carries
across with ``interop.params_from_reference``.  Decode updates the caches
in place; its position lives in device memory (an int is accepted and
filled on the device once), so a step can be captured as a CUDA graph.
A cache tree mixes, a period position each, attention caches (K/V and
positions) and SSM ones (state and conv tail, no positions).

On a mesh (``models/sharding.py``) the sequence mode takes the sharder's
``constrain`` and ``q_pad`` (``blocks.apply_layer_seq``); the embedding
and the head are ``kernels/ops.Placed`` slices of the vocabulary there: a lookup takes the tokens this rank holds
and sums the ranks' rows over "model" (each token's row comes from one
rank, the rest add zeros), and the logits are gathered column-parallel.
``decode_step`` takes the sharder's ``decode_attn``.  ``loss_fn`` takes the
train step's ``constrain`` and ``q_pad`` and gives the global loss; its
collectives differentiate (``kernels/ops.py``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.qtensor import QuantizedTensor, dequantize_tensor
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention, blocks, moe
from repro_torch.models.blocks import NO_CONSTRAIN
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
    """Exact parameter count of the model, from shapes on the meta device
    (no memory: gemma2-27b's 27.2 B).  ``active_only`` counts each expert
    stack ([n_periods, E, in, out] under an FFN) at top_k / n_experts, the
    parameters a token reads, as the reference.  An encoder-decoder counts
    ``seq2seq.init_params``' tree."""
    if cfg.encoder_decoder:
        from repro_torch.models import seq2seq

        shapes = seq2seq.init_params(cfg, device="meta")
    else:
        shapes = init_params(cfg, device="meta")

    def count(tree, keys=()):
        if isinstance(tree, dict):
            return sum(count(v, keys + (k,)) for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return sum(count(v, keys) for v in tree)
        n = math.prod(tree.shape)
        if (active_only and cfg.n_experts and "ffn" in keys and keys[-1] in moe.MOE_WEIGHTS
                and tree.ndim == 4):
            n = n * cfg.top_k // cfg.n_experts
        return n

    return count(shapes)


def head_matrix(params):
    """[V, D] output projection (tied embedding or lm_head; maybe quantized)."""
    return params.get("lm_head", params["embed"])


def _whole_on_data(w):
    """A head or embedding leaf gathered over "data" where a train state
    stores it cut (``Placed.gathered``), and its local tensor where it is
    not split over "model" either."""
    if not isinstance(w, ops.Placed):
        return w
    w = w.gathered()
    return w if w.tp_split() else w.local


def logits_from_hidden(params, h, cfg):
    """h [..., D] -> logits [..., V]."""
    w = _whole_on_data(head_matrix(params))
    if isinstance(w, QuantizedTensor) or (isinstance(w, ops.Placed)
                                          and isinstance(w.local, QuantizedTensor)):
        out = linear(h, w, mode=cfg.matmul_mode)
    elif isinstance(w, ops.Placed):
        out = ops.tp_column_parallel(h, lambda hl: matmul_rounded(hl, w.local), w.sharder)
    else:
        out = matmul_rounded(h, w)
    return softcap(out, cfg.final_logit_softcap)


def embed_inputs(params, tokens, cfg):
    emb = _whole_on_data(params["embed"])
    placed = isinstance(emb, ops.Placed)
    if placed:
        s, emb = emb.sharder, emb.local
    if isinstance(emb, QuantizedTensor):
        emb = dequantize_tensor(emb)
    emb = emb.to(torch.bfloat16)
    if not placed:
        return emb[tokens]
    # this rank's vocabulary rows [r * V_loc, (r + 1) * V_loc)
    r, _ = s.coord(s.tp)
    idx = tokens.to(torch.int64) - r * emb.shape[0]
    mine = (idx >= 0) & (idx < emb.shape[0])
    rows = emb[torch.clamp(idx, 0, emb.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return ops.all_reduce(rows, s.group(s.tp))


def backbone_seq_aux(params, tokens, cfg, *, write_cache=False, cache_len=None,
                     pad_mask=None, constrain=NO_CONSTRAIN, q_pad=None, remat=False):
    """The backbone in sequence mode: (normed hidden [B, S, D], caches or
    None, the MoE layers' summed aux loss), the reference's
    ``backbone_seq``.  ``pad_mask`` [B, S] (True = real token) reaches the
    MoE routers' capacity accounting only: the Server passes it for
    bucket-padded prefills, so MoE archs bucket safely.  ``constrain`` and
    ``q_pad``: the sharder's (``blocks.apply_layer_seq``); ``remat``:
    ``blocks.apply_stack_seq``'s."""
    x = embed_inputs(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, caches, aux = blocks.apply_stack_seq(params["stack"], x, cfg, positions=positions,
                                            cache_len=cache_len, write_cache=write_cache,
                                            pad_mask=pad_mask, constrain=constrain,
                                            q_pad=q_pad, remat=remat)
    return norm(params["final_norm"], x, cfg.norm_type), caches, aux


def backbone_seq(params, tokens, cfg, *, write_cache=False, cache_len=None, pad_mask=None,
                 constrain=NO_CONSTRAIN, q_pad=None):
    """``backbone_seq_aux`` without the aux loss: (hidden, caches or None)."""
    h, caches, _ = backbone_seq_aux(params, tokens, cfg, write_cache=write_cache,
                                    cache_len=cache_len, pad_mask=pad_mask,
                                    constrain=constrain, q_pad=q_pad)
    return h, caches


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


def loss_fn(params, tokens, labels, cfg, *, constrain=NO_CONSTRAIN, q_pad=None,
            loss_chunk: int = 512, remat: bool = True):
    """Mean next-token cross entropy over labels >= 0, logits formed per
    sequence chunk (the tail past a whole number of chunks is dropped, as
    in the reference), plus the MoE aux loss (router_aux_weight a layer).
    Under autograd each chunk's loss is recomputed in the backward (the
    reference's ``jax.checkpoint(chunk_loss)``: no chunk's logits are kept)
    and, with ``remat``, each period of the stack
    (``blocks.apply_stack_seq``).

    On a mesh (the train step's ``constrain`` and ``q_pad``) the batch is
    this rank's slice: the loss is the global ``sum(tot) / sum(cnt)``, the
    per-rank sums all-reduced over the data axes (``constrain.batch_sum``),
    not a mean of per-rank means; a head or embedding stored cut over
    "data" is gathered once here.  The MoE aux term is the global batch's
    (``moe.moe_ffn``), the same on every rank."""
    params = {k: v.gathered() if k in ("embed", "lm_head") and isinstance(v, ops.Placed)
              else v for k, v in params.items()}
    h, _, aux = backbone_seq_aux(params, tokens, cfg, constrain=constrain, q_pad=q_pad,
                                 remat=remat)
    B, S, D = h.shape
    loss_chunk = min(loss_chunk, S)

    def chunk_loss(h_c, y):
        logits = logits_from_hidden(params, h_c, cfg).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, torch.clamp(y, min=0)[..., None].long())[..., 0]
        mask = (y >= 0).to(torch.float32)
        return torch.sum((lse - ll) * mask), torch.sum(mask)

    ckpt = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // loss_chunk):
        sl = slice(c * loss_chunk, (c + 1) * loss_chunk)
        if ckpt:
            t, n = blocks.recompute_in_backward(chunk_loss, h[:, sl], labels[:, sl])
        else:
            t, n = chunk_loss(h[:, sl], labels[:, sl])
        tot = tot + t
        cnt = cnt + n
    cnt = constrain.batch_sum(cnt)
    loss = constrain.batch_sum(tot / torch.clamp(cnt, min=1.0))
    if cfg.n_experts:
        loss = loss + cfg.router_aux_weight * aux / max(1, cfg.n_layers)
    return loss


def prefill(params, tokens, cfg, *, cache_len=None, pad_mask=None, constrain=NO_CONSTRAIN,
            q_pad=None):
    """Process a prompt; returns (last-token logits, caches).  ``cache_len``
    reserves decode room (defaults to the prompt length); ``pad_mask``,
    ``constrain`` and ``q_pad`` as in ``backbone_seq_aux`` (the logits are
    the last row's, padded or not)."""
    h, caches = backbone_seq(params, tokens, cfg, write_cache=True, cache_len=cache_len,
                             pad_mask=pad_mask, constrain=constrain, q_pad=q_pad)
    return logits_from_hidden(params, h[:, -1], cfg), caches


def decode_step(params, token, caches, pos, cfg, *, decode_attn=blocks.local_decode_attn,
                constrain=NO_CONSTRAIN):
    """One decoding step: token [B] at ``pos``: an int or a 0-d int32 tensor
    (every row at one position, over shared caches) or a [B] one (a
    position a row over per-slot caches, -1 = idle row).  ``decode_attn``
    writes each layer's token and attends (the paged pool passes its own,
    a mesh the sharder's); ``constrain`` places the SSM and MoE layers on a
    mesh.  Returns (logits [B, V], caches), the caches updated in place.
    Nothing here reads a device value on the host, so the step can be
    captured as a CUDA graph."""
    x = embed_inputs(params, token, cfg)
    pos = attention.as_position(pos, x.device)
    x, caches = blocks.apply_stack_decode(params["stack"], x, caches, pos, cfg,
                                          decode_attn=decode_attn, constrain=constrain)
    x = norm(params["final_norm"], x, cfg.norm_type)
    return logits_from_hidden(params, x, cfg), caches


def init_caches(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
                per_slot: bool = False, device=None):
    """Empty decode caches; packed k-bit leaves when cfg.kv_bits < 16;
    ``per_slot`` gives each row its own position array (the slot pool)."""
    return blocks.init_stack_cache(cfg, batch, cache_len, dtype, per_slot=per_slot,
                                   device=resolve_device(device))
