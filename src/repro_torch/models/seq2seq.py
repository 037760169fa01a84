"""Encoder-decoder backbone (seamless-m4t-large-v2) — port of
``repro/models/seq2seq.py``.

The audio frontend is a stub, as in the reference: ``encode`` takes
precomputed frame embeddings [B, S, d_model].  The encoder is a stack of
bidirectional self-attention layers; a decoder layer is causal
self-attention, cross-attention over the encoder's output (the memory) and
an FFN.  Decoding keeps a self KV cache of ``cfg.decoder_cache_len`` slots
and a cross K/V computed once at prefill.

The parameter tree has the reference's keys and layout: ``enc_stack`` and
``dec_stack`` are dicts whose leaves carry a leading layer axis (the
reference's ``jnp.stack`` over layers), so a reference tree carries across
with ``interop.params_from_reference`` and ``blocks.take(stack, i)`` reads
layer i as views.  The reference's ``lax.scan`` over layers is a Python loop
over the config's ``n_encoder_layers`` and ``n_layers`` (a config cut in
depth runs the first layers of a full tree).

As in the reference, the self cache is always bf16: ``cfg.kv_bits`` is not
read here, and both attention reads of a decode step go through
``attention.decode_attention``'s masked partials.  Every quantized product
goes through ``layers.dense`` (on the card B1's decode GEMV or prefill
GEMM).  ``decode_step`` updates the self cache in place and reads no device
value on the host, so a step can be captured as a CUDA graph.

The decoder-only ``Engine``, ``Server`` and ``launch/serve.py`` do not serve
this arch (the reference's have no encoder-decoder path either); they
refuse it at construction (``blocks.check_dense``).

On a mesh (``models/sharding.py``) every function takes the sharder's
``constrain`` and ``q_pad``, as ``models/lm.py`` does: the params are
``kernels/ops.Placed`` slices whose products do their own collectives, and
each attention of the sequence mode (the encoder's, the decoder's self and
cross reads) splits its q heads over "model" and gathers them after
(``blocks.attend_seq``).  ``loss_fn`` gives the global loss
(``constrain.batch_sum``) of a train step whose rows are split over the
data axes.  ``remat`` recomputes each layer in the backward
(``blocks.recompute_in_backward``), the reference's ``jax.checkpoint`` of
its scan body.  A decode step reads the self cache through the sharder's
``decode_attn_fn(B, cfg.decoder_cache_len)`` and the cross cache through
its ``cross_attn_fn(B, S_m)`` (each rank's window of the source, combined
over the sequence group).  With the defaults every function is the
unsharded one it was.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models.layers import NO_CONSTRAIN, Init, dense, norm
from repro_torch.models.lm import embed_inputs, logits_from_hidden


def init_params(cfg, *, seed: int = 0, device=None, dtype=torch.float32) -> dict:
    """Seeded random parameters on ``device`` (CUDA by default), weights in
    ``dtype``, norm scales and biases f32 — the reference's init scales and
    tree, drawn from a ``torch.Generator`` (different numbers from
    jax.random).  A stacked leaf has a leading layer axis."""
    init = Init(seed, resolve_device(device), dtype)
    enc = init.stacked(cfg.n_encoder_layers)
    dec = init.stacked(cfg.n_layers)
    D = cfg.d_model
    return {
        "frame_proj": init.dense(D, D),
        "enc_stack": {
            "mixer_norm": enc.norm(D, cfg.norm_type),
            "mixer": attn_mod.init_attention(enc, cfg),
            "ffn_norm": enc.norm(D, cfg.norm_type),
            "ffn": blocks.init_mlp(enc, cfg),
        },
        "enc_final_norm": init.norm(D, cfg.norm_type),
        "embed": init.normal((cfg.vocab_size, D), 0.02),
        "dec_stack": {
            "self_norm": dec.norm(D, cfg.norm_type),
            "self_attn": attn_mod.init_attention(dec, cfg),
            "cross_norm": dec.norm(D, cfg.norm_type),
            "cross_attn": attn_mod.init_attention(dec, cfg),
            "ffn_norm": dec.norm(D, cfg.norm_type),
            "ffn": blocks.init_mlp(dec, cfg),
        },
        "final_norm": init.norm(D, cfg.norm_type),
        "lm_head": init.normal((cfg.vocab_size, D), D**-0.5),
    }


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def _layer(body, remat: bool, x, i: int):
    """``body(x, i)``, recomputed in the backward with ``remat`` under
    autograd (only x is kept)."""
    if remat and torch.is_grad_enabled():
        return blocks.recompute_in_backward(body, x, i)
    return body(x, i)


def encode(params, frames, cfg, *, constrain=NO_CONSTRAIN, q_pad=None, remat=False):
    """frames [B, S, D] (stub embeddings) -> memory [B, S, D] bf16.
    ``constrain`` and ``q_pad``: the sharder's; ``remat``: recompute each
    layer in the backward."""
    mm = cfg.matmul_mode
    x = dense(params["frame_proj"], frames.to(torch.bfloat16), mode=mm)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    stack = params["enc_stack"]

    def body(x, i):
        p = blocks.take(stack, i)
        h = norm(p["mixer_norm"], x, cfg.norm_type)
        q, k, v = attn_mod.project_qkv(p["mixer"], h, cfg, positions)
        o = blocks.attend_seq(q, k, v, window=0, cap=0.0, causal=False, constrain=constrain,
                              q_pad=q_pad)
        x = x + dense(p["mixer"]["wo"], o.reshape(B, S, -1), mode=mm)
        h = norm(p["ffn_norm"], x, cfg.norm_type)
        return x + blocks.mlp(p["ffn"], h, cfg)

    for i in range(cfg.n_encoder_layers):
        x = _layer(body, remat, x, i)
    return norm(params["enc_final_norm"], x, cfg.norm_type)


# --------------------------------------------------------------------------
# decoder, sequence mode (train / prefill)
# --------------------------------------------------------------------------

def _cross_kv(p_attn, memory, cfg):
    """The cross-attention's K and V over the memory: [B, S_m, K, Dh] each."""
    B, S_m, _ = memory.shape
    K, Dh = cfg.n_kv_heads, cfg.head_dim
    k = dense(p_attn["wk"], memory, mode=cfg.matmul_mode).reshape(B, S_m, K, Dh)
    v = dense(p_attn["wv"], memory, mode=cfg.matmul_mode).reshape(B, S_m, K, Dh)
    return k, v


def decoder_seq(params, tokens, memory, cfg, *, constrain=NO_CONSTRAIN, q_pad=None,
                write_cache=False, remat=False):
    """tokens [B, T] over memory [B, S_m, D] -> (normed hidden [B, T, D],
    caches or None).  With ``write_cache`` the caches are ``decode_step``'s:
    (self cache, cross cache), each a dict of leaves stacked over the
    decoder layers.  The self cache is ``attention.init_kv_cache`` at
    ``cfg.decoder_cache_len`` slots in the K/V dtype (bf16) with the prefix's
    last positions written (``write_cache_prefill``); the cross cache holds
    the reference's (kx, vx) and the source's positions, built once here.
    ``constrain``, ``q_pad`` and ``remat`` as in ``encode`` (no remat while
    writing caches)."""
    mm = cfg.matmul_mode
    x = embed_inputs(params, tokens, cfg)
    B, T = tokens.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    stack = params["dec_stack"]
    n = cfg.n_layers
    out = {"self": None, "cross": None}

    def body(x, i):
        p = blocks.take(stack, i)
        # self attention (causal)
        h = norm(p["self_norm"], x, cfg.norm_type)
        q, k, v = attn_mod.project_qkv(p["self_attn"], h, cfg, positions)
        o = blocks.attend_seq(q, k, v, window=0, cap=0.0, constrain=constrain, q_pad=q_pad)
        x = x + dense(p["self_attn"]["wo"], o.reshape(B, T, -1), mode=mm)
        if write_cache:
            if out["self"] is None:
                one = attn_mod.init_kv_cache(cfg, B, cfg.decoder_cache_len, k.dtype,
                                             device=x.device)
                out["self"] = {key: leaf.unsqueeze(0).repeat((n,) + (1,) * leaf.ndim)
                               for key, leaf in one.items()}
            L = cfg.decoder_cache_len
            attn_mod.write_cache_prefill(blocks.take(out["self"], i), k[:, -L:], v[:, -L:])
        # cross attention (no mask)
        h = norm(p["cross_norm"], x, cfg.norm_type)
        qx = dense(p["cross_attn"]["wq"], h, mode=mm).reshape(B, T, H, Dh)
        kx, vx = _cross_kv(p["cross_attn"], memory, cfg)
        ox = blocks.attend_seq(qx, kx, vx, window=0, cap=0.0, causal=False,
                               constrain=constrain, q_pad=q_pad)
        x = x + dense(p["cross_attn"]["wo"], ox.reshape(B, T, -1), mode=mm)
        if write_cache:
            if out["cross"] is None:
                S_m = kx.shape[1]
                out["cross"] = {"k": kx.new_empty((n,) + kx.shape),
                                "v": vx.new_empty((n,) + vx.shape),
                                "pos": torch.arange(S_m, dtype=torch.int32, device=x.device)
                                .expand(n, S_m).contiguous()}
            out["cross"]["k"][i].copy_(kx)
            out["cross"]["v"][i].copy_(vx)
        # ffn
        h = norm(p["ffn_norm"], x, cfg.norm_type)
        return x + blocks.mlp(p["ffn"], h, cfg)

    for i in range(n):
        x = _layer(body, remat and not write_cache, x, i)
    x = norm(params["final_norm"], x, cfg.norm_type)
    return x, ((out["self"], out["cross"]) if write_cache else None)


def loss_fn(params, frames, tokens, labels, cfg, *, constrain=NO_CONSTRAIN, q_pad=None,
            remat=True):
    """Mean cross entropy of the decoder's logits against ``labels`` over
    labels >= 0, given the encoded frames.  On a mesh (the train step's
    ``constrain`` and ``q_pad``) the batch is this rank's slice and the loss
    the global ``sum(tot) / sum(cnt)``, the per-rank sums all-reduced over
    the data axes (``constrain.batch_sum``).  ``remat``: each encoder and
    decoder layer recomputed in the backward."""
    memory = encode(params, frames, cfg, constrain=constrain, q_pad=q_pad, remat=remat)
    h, _ = decoder_seq(params, tokens, memory, cfg, constrain=constrain, q_pad=q_pad,
                       remat=remat)
    logits = logits_from_hidden(params, h, cfg).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    cnt = constrain.batch_sum(torch.sum(mask))
    return constrain.batch_sum(torch.sum((lse - ll) * mask) / torch.clamp(cnt, min=1.0))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def prefill(params, frames, bos_tokens, cfg, *, constrain=NO_CONSTRAIN, q_pad=None):
    """Encode the source and run the decoder over the BOS prefix: (logits
    of the prefix's last position [B, V], caches for ``decode_step``).  On a
    mesh the caches come back whole; ``Sharder.shard_caches`` cuts them."""
    memory = encode(params, frames, cfg, constrain=constrain, q_pad=q_pad)
    h, caches = decoder_seq(params, bos_tokens, memory, cfg, constrain=constrain, q_pad=q_pad,
                            write_cache=True)
    return logits_from_hidden(params, h[:, -1], cfg), caches


def decode_step(params, token, caches, pos, cfg, *, constrain=NO_CONSTRAIN,
                decode_attn=blocks.local_decode_attn, cross_attn=None):
    """One decoding step: token [B] at ``pos`` (an int or a 0-d int32
    tensor: every row at one position) over ``caches`` = (self cache, cross
    cache) from ``prefill``.  Each layer writes the token's K/V into its
    self cache in place through ``decode_attn`` (``blocks.local_decode_attn``,
    no ``kvq``, as the reference) and reads every source position of its
    cross cache through ``cross_attn(q, layer cache)`` (the plain read by
    default).  On a mesh (``constrain`` a sharder's) the caches are placed
    by ``shard_caches`` and both reads are the sharder's:
    ``decode_attn_fn(B, cfg.decoder_cache_len)`` and ``cross_attn_fn(B,
    S_m)``.  Returns (logits [B, V], caches)."""
    mm = cfg.matmul_mode
    x = embed_inputs(params, token, cfg)
    B = x.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    pos = attn_mod.as_position(pos, x.device)
    positions = pos[None]
    self_c, cross = caches
    if cross_attn is None:
        s = getattr(constrain, "sharder", None)
        if s is not None and s.mesh is not None and not s.replicate:
            raise ValueError("a sharded decode step reads its cross cache through the "
                             "sharder's cross_attn_fn(B, S_m): pass cross_attn=")
        every = cross["pos"].shape[-1] + 1   # past the last source position
        cross_attn = lambda q, cache: attn_mod.decode_attention(q, cache, every)  # noqa: E731
    stack = params["dec_stack"]
    for i in range(cfg.n_layers):
        p = blocks.take(stack, i)
        h = norm(p["self_norm"], x, cfg.norm_type)
        q, k, v = attn_mod.project_qkv(p["self_attn"], h[:, None, :], cfg, positions)
        o = decode_attn(q[:, 0], k[:, 0], v[:, 0], blocks.take(self_c, i), pos)
        x = x + dense(p["self_attn"]["wo"], o.reshape(B, -1), mode=mm)
        h = norm(p["cross_norm"], x, cfg.norm_type)
        qx = dense(p["cross_attn"]["wq"], h, mode=mm).reshape(B, H, Dh)
        ox = cross_attn(qx, blocks.take(cross, i))
        x = x + dense(p["cross_attn"]["wo"], ox.reshape(B, -1), mode=mm)
        h = norm(p["ffn_norm"], x, cfg.norm_type)
        x = x + blocks.mlp(p["ffn"], h, cfg)
    x = norm(params["final_norm"], x, cfg.norm_type)
    return logits_from_hidden(params, x, cfg), caches
