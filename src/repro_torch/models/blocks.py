"""Layer composition: (attention, MLP) blocks over the stacked layer axis —
port of the dense path of ``repro/models/blocks.py``.

Parameters keep the reference layout: ``stack`` is a list, one entry per
position in the repeating period (1 for a dense model), whose leaves carry
a leading n_periods axis.  The reference's ``lax.scan`` over that axis is a
Python loop here: each step takes item i of every leaf (``take``).  Decode
caches have the same stacked layout and are updated **in place** through
those per-layer views.

``apply_stack_prefill_chunk`` runs one chunk of a chunked prefill over a
dense bf16 workspace.  A decode position is an int32 tensor (0-d or [B],
``attention.write_cache_decode``), never turned into a host int.

Not in this slice: MoE and SSM layers, sliding windows and sharding
constraints.
"""

from __future__ import annotations

import torch

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels.kv_dequant import kv_spec
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import activation, dense, norm


def init_mlp(init, cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": init.dense(D, F),
        "w_up": init.dense(D, F),
        "w_down": init.dense(F, D, scale=F**-0.5),
    }


def mlp(params, x, cfg):
    mm = cfg.matmul_mode
    h = activation(dense(params["w_gate"], x, mode=mm), cfg.act) \
        * dense(params["w_up"], x, mode=mm)
    return dense(params["w_down"], h, mode=mm)


def init_layer(init, cfg) -> dict:
    return {
        "mixer_norm": init.norm(cfg.d_model, cfg.norm_type),
        "mixer": attn_mod.init_attention(init, cfg),
        "ffn_norm": init.norm(cfg.d_model, cfg.norm_type),
        "ffn": init_mlp(init, cfg),
    }


def check_dense(cfg) -> None:
    """Raise for the parts of the config this slice does not serve."""
    if cfg.scan_period() != 1 or cfg.n_experts or cfg.attn_period != 1:
        raise NotImplementedError(f"{cfg.name}: only dense attention+MLP stacks are ported")
    if cfg.sliding_window or cfg.post_block_norm or cfg.input_kind != "tokens":
        raise NotImplementedError(f"{cfg.name}: sliding windows, sandwich norms and "
                                  "frame inputs are not ported yet")


def take(tree, i: int):
    """Item i of the leading (stacked layer) axis of every leaf, as views."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.select(i)
    return tree[i]


def apply_layer_seq(p, x, *, cfg, positions, cache_len=None, write_cache=False):
    """Sequence mode (prefill).  Returns (x, cache or None)."""
    cache = None
    h = norm(p["mixer_norm"], x, cfg.norm_type)
    q, k, v = attn_mod.project_qkv(p["mixer"], h, cfg, positions)
    o = attn_mod.flash_attention(q, k, v, causal=True, cap=cfg.attn_logit_softcap)
    o = dense(p["mixer"]["wo"], o.reshape(x.shape[0], x.shape[1], -1), mode=cfg.matmul_mode)
    if write_cache:
        B, S = x.shape[:2]
        kvq = kv_spec(cfg)
        cache = attn_mod.init_kv_cache(cfg, B, max(cache_len or S, S), k.dtype, kvq=kvq,
                                       device=x.device)
        attn_mod.write_cache_prefill(cache, k, v, kvq=kvq)
    x = x + o
    h = norm(p["ffn_norm"], x, cfg.norm_type)
    return x + mlp(p["ffn"], h, cfg), cache


def apply_layer_prefill_chunk(p, x, cache, chunk_start: int, *, cfg):
    """One layer over one chunk of a chunked prefill.  x [B,C,D] holds C
    consecutive prompt rows from absolute position ``chunk_start``;
    ``cache`` is this layer's dense bf16 workspace {"k","v": [B,Sb,K,Dh],
    "pos": [Sb]}, already holding every earlier chunk.  Writes the chunk's
    K/V in place, attends over the workspace and runs the same row-wise
    math as ``apply_layer_seq``.  Returns x."""
    C = x.shape[1]
    positions = chunk_start + torch.arange(C, dtype=torch.int32, device=x.device)
    h = norm(p["mixer_norm"], x, cfg.norm_type)
    q, k, v = attn_mod.project_qkv(p["mixer"], h, cfg, positions)
    cache["k"][:, chunk_start: chunk_start + C] = k.to(cache["k"].dtype)
    cache["v"][:, chunk_start: chunk_start + C] = v.to(cache["v"].dtype)
    cache["pos"][chunk_start: chunk_start + C] = positions
    o = attn_mod.prefill_chunk_attention(q, cache["k"], cache["v"], chunk_start,
                                         cap=cfg.attn_logit_softcap)
    o = dense(p["mixer"]["wo"], o.reshape(x.shape[0], C, -1), mode=cfg.matmul_mode)
    x = x + o
    h = norm(p["ffn_norm"], x, cfg.norm_type)
    return x + mlp(p["ffn"], h, cfg)


def apply_layer_decode(p, x, cache, pos: torch.Tensor, *, cfg):
    """Single-token mode.  x [B,D]; pos a 0-d (shared) or [B] (a position a
    row, -1 = idle) int32 tensor.  Writes this token into ``cache`` in
    place.  Returns x."""
    h = norm(p["mixer_norm"], x, cfg.norm_type)
    # RoPE positions [..., seq]: [1] broadcasts over the batch, [B, 1]
    # rotates each row by its own position
    positions = pos[:, None] if pos.ndim else pos[None]
    q, k, v = attn_mod.project_qkv(p["mixer"], h[:, None, :], cfg, positions)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    kvq = kv_spec(cfg)
    attn_mod.write_cache_decode(cache, k, v, pos, kvq=kvq)
    o = attn_mod.decode_attention(q, cache, pos, cap=cfg.attn_logit_softcap, kvq=kvq)
    x = x + dense(p["mixer"]["wo"], o.reshape(x.shape[0], -1), mode=cfg.matmul_mode)
    h = norm(p["ffn_norm"], x, cfg.norm_type)
    return x + mlp(p["ffn"], h, cfg)


def init_stack(init, cfg) -> list:
    """Stacked params: one period position whose leaves carry a leading
    n_layers axis."""
    check_dense(cfg)
    return [init_layer(init.stacked(cfg.n_layers), cfg)]


def apply_stack_seq(stack, x, cfg, *, positions, cache_len=None, write_cache=False):
    """All layers in sequence mode.  Returns (x, caches): caches is a
    one-entry tuple of dicts stacked over layers, as the reference's."""
    check_dense(cfg)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = apply_layer_seq(take(stack[0], i), x, cfg=cfg, positions=positions,
                                   cache_len=cache_len, write_cache=write_cache)
        caches.append(cache)
    if not write_cache:
        return x, None
    return x, ({k: torch.stack([c[k] for c in caches]) for k in caches[0]},)


def apply_stack_prefill_chunk(stack, x, caches, chunk_start: int, cfg):
    """All layers over one prefill chunk; ``caches`` is a dense bf16
    workspace in init_stack_cache's layout, updated in place.  Returns
    (x, caches)."""
    check_dense(cfg)
    for i in range(cfg.n_layers):
        x = apply_layer_prefill_chunk(take(stack[0], i), x, take(caches[0], i), chunk_start,
                                      cfg=cfg)
    return x, caches


def apply_stack_decode(stack, x, caches, pos: torch.Tensor, cfg):
    """All layers in decode mode at ``pos`` (a 0-d or [B] int32 tensor);
    ``caches`` (init_stack_cache's layout) are updated in place.  Returns
    (x, caches)."""
    check_dense(cfg)
    for i in range(cfg.n_layers):
        x = apply_layer_decode(take(stack[0], i), x, take(caches[0], i), pos, cfg=cfg)
    return x, caches


def init_stack_cache(cfg, batch: int, cache_len: int, dtype=None, *, per_slot: bool = False,
                     device=None):
    """Empty caches in apply_stack_decode's layout (``per_slot``: a position
    array a row)."""
    check_dense(cfg)
    one = attn_mod.init_kv_cache(cfg, batch, cache_len, dtype or torch.bfloat16,
                                 kvq=kv_spec(cfg), per_slot=per_slot, device=device)
    return ({k: v.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * v.ndim)
             for k, v in one.items()},)
