"""Layer composition: (mixer, FFN) blocks over the stacked layer axis —
port of the decoder path of ``repro/models/blocks.py``.

Layers are grouped into the architecture's smallest repeating period
(``ArchConfig.scan_period``): 1 for a llama-style stack or mamba2, 2 for
gemma2's local and global layers, 8 for jamba (one attention layer, seven
SSM ones, MoE every second).  Parameters keep the reference layout: ``stack``
is a list, one entry per position in the period, whose leaves carry a
leading n_periods axis.  The reference's ``lax.scan`` over periods is a
Python loop here, period by period and position by position (layer
``p * period + j`` is item p of ``stack[j]``, ``take``).  Decode caches
have the same layout, a tuple of one dict a position: a windowed position
("attn_local", or "attn" under ``cfg.sliding_window``) holds a ring of
min(cache length, window) slots beside the full-length caches of the
others, and an SSM position ("ssm", ``models/ssm.py``) its recurrent
state and conv tail ({"state", "conv"}, no position axis); each is updated
**in place** through its per-layer view.
gemma2's sandwich norms (``cfg.post_block_norm``) norm the mixer's and the
FFN's outputs before each residual add.  A position's FFN is the dense MLP
("mlp"), the mixture of experts ("moe", ``models/moe.py``) or none (an arch
with neither d_ff nor experts, mamba2; the reference's None): sequence mode
threads ``pad_mask`` to its router's capacity accounting and sums its aux
losses; decode masks idle rows (a [B] position < 0) out of its capacity,
and a shared (0-d) position leaves it unmasked, as the reference.

``apply_stack_prefill_chunk`` runs one chunk of a chunked prefill over a
dense bf16 workspace, for full attention and dense MLPs only, as the
reference asserts.
A decode position is an int32 tensor (0-d or [B],
``attention.write_cache_decode``), never turned into a host int.  A decode
layer writes its token and attends through ``decode_attn``, the
reference's hook: ``local_decode_attn`` over a slot cache by default, the
paged pool's closure (``serving/pages.paged_decode_attn_fn``) over pages.

The encoder-decoder with frame inputs (``models/seq2seq.py``) uses ``mlp``,
``take``, ``attend_seq``, ``recompute_in_backward`` and ``local_decode_attn``
from here and has its own layer loops; ``check_dense`` refuses it on this
path.

On a mesh (``models/sharding.py``) the sequence mode and the decode take
the sharder's ``constrain`` (the SSM layers' heads and channels, the MoE
layers' experts: ``models/ssm.py``, ``models/moe.py``) and the sequence mode
its ``q_pad``, as the reference's: q heads are zero-padded to
``q_pad`` inside each KV group (the padded heads attend like any other and
are sliced off before ``wo``), split over "model" with the batch over the
data axes (``constrain(q, "heads")``, the KV heads a rank's q heads read:
``constrain(k, "kv_heads")``), attended, and gathered back
(``constrain.gather``).  The defaults (``NO_CONSTRAIN``, no padding) leave
every unsharded path as it was.  Stacked weights are ``kernels/ops.Placed``
slices there, and ``take`` selects a layer of them (gathered over "data"
where a train state stores them cut); the products and the decode read
(the sharder's ``decode_attn``) do their own collectives.  Under autograd
``apply_stack_seq(remat=True)`` recomputes each period in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels import ops
from repro_torch.kernels.kv_dequant import kv_spec
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import NO_CONSTRAIN, activation, dense, norm


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


def init_layer(init, mixer: str, ffn: str | None, cfg) -> dict:
    """One position's params: an attention or SSM mixer, and an FFN unless
    ``ffn`` is None (no ffn_norm then, as the reference)."""
    p = {"mixer_norm": init.norm(cfg.d_model, cfg.norm_type)}
    p["mixer"] = (attn_mod.init_attention(init, cfg) if mixer.startswith("attn")
                  else ssm_mod.init_ssm(init, cfg))
    if ffn is not None:
        p["ffn_norm"] = init.norm(cfg.d_model, cfg.norm_type)
        p["ffn"] = moe_mod.init_moe(init, cfg) if ffn == "moe" else init_mlp(init, cfg)
    if cfg.post_block_norm:
        p["post_mixer_norm"] = init.norm(cfg.d_model, cfg.norm_type)
        if ffn is not None:
            p["post_ffn_norm"] = init.norm(cfg.d_model, cfg.norm_type)
    return p


def check_dense(cfg) -> None:
    """Raise for a config the decoder-only path does not run: an
    encoder-decoder with frame inputs runs through ``models/seq2seq.py``."""
    if cfg.encoder_decoder or cfg.input_kind != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder with frame inputs runs through "
            "models/seq2seq.py (encode, prefill, decode_step), not the decoder-only "
            "path of models/lm.py, the Engine or the Server")


def mixer_window(mixer: str, cfg) -> int:
    """The sliding window of a layer position: "attn_local" always, "attn"
    under ``cfg.sliding_window``, "attn_global" never (0 = full attention)."""
    if mixer == "attn_local" or (mixer == "attn" and cfg.sliding_window):
        return cfg.sliding_window
    return 0


def stack_schedule(cfg) -> list:
    """The layers of one period, (mixer, ffn) a position: mixer "attn",
    "attn_local", "attn_global" or "ssm"; ffn "mlp", "moe" or None (an arch
    with neither d_ff nor experts)."""
    check_dense(cfg)
    has_ffn = bool(cfg.d_ff or cfg.n_experts)
    return [(m, f if has_ffn else None) for m, f in cfg.layer_schedule()[:cfg.scan_period()]]


def take(tree, i: int):
    """Item i of the leading (stacked layer) axis of every leaf, as views."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    if isinstance(tree, (QuantizedTensor, ops.Placed)):
        return tree.select(i)
    return tree[i]


def _layers(stack, cfg):
    """(layer params, position in the period, period index, mixer, window,
    ffn) in depth order."""
    sched = stack_schedule(cfg)
    for p in range(cfg.n_layers // len(sched)):
        for j, (mixer, ffn) in enumerate(sched):
            yield take(stack[j], p), j, p, mixer, mixer_window(mixer, cfg), ffn


def _post(p, key, o, cfg):
    """A sandwich norm of a block's output, where the config has them."""
    return norm(p[key], o, cfg.norm_type) if cfg.post_block_norm else o


def _ffn(p, h, cfg, ffn: str, pad_mask=None, constrain=NO_CONSTRAIN):
    """The position's FFN on normed h [B, S, D]: (output, aux dict)."""
    if ffn == "moe":
        return moe_mod.moe_ffn(p["ffn"], h, cfg, pad_mask, constrain=constrain)
    return mlp(p["ffn"], h, cfg), {}


def _pad_heads(q, K: int, q_pad: int):
    """q [B, S, H, Dh] with zero heads appended inside each of the K groups
    up to q_pad heads in all: head g of group k stays at k * q_pad // K + g,
    so the GQA grouping of the real heads is kept."""
    B, S, H, Dh = q.shape
    qg = q.reshape(B, S, K, H // K, Dh)
    pad = qg.new_zeros((B, S, K, q_pad // K - H // K, Dh))
    return torch.cat([qg, pad], dim=3).reshape(B, S, q_pad, Dh)


def _unpad_heads(o, K: int, H: int):
    """``_pad_heads`` undone: the real heads of o [B, S, q_pad, Dh]."""
    B, S, Hp, Dh = o.shape
    return o.reshape(B, S, K, Hp // K, Dh)[:, :, :, :H // K].reshape(B, S, H, Dh)


def attend_seq(q, k, v, *, window, cap, causal=True, constrain=NO_CONSTRAIN, q_pad=None):
    """The prefill read: q [B,S,H,Dh] over k, v [B,Skv,K,Dh], q heads padded
    to ``q_pad`` and split, attended (causal or not) and gathered by
    ``constrain``."""
    H, K = q.shape[2], k.shape[2]
    padded = bool(q_pad) and q_pad != H
    if padded:
        q = _pad_heads(q, K, q_pad)
    shape = q.shape
    o = attn_mod.flash_attention(constrain(q, "heads"), constrain(k, "kv_heads"),
                                 constrain(v, "kv_heads"), causal=causal, window=window,
                                 cap=cap)
    o = constrain.gather(o, "heads", shape)
    return _unpad_heads(o, K, H) if padded else o


def apply_layer_seq(p, x, *, cfg, positions, mixer="attn", window=0, cache_len=None,
                    write_cache=False, ffn="mlp", pad_mask=None, constrain=NO_CONSTRAIN,
                    q_pad=None):
    """Sequence mode (prefill).  Returns (x, cache or None, aux); a
    windowed layer's cache is its ring, min(cache length, window) slots, an
    SSM layer's the tail state and conv of ``ssm.ssm_block``.
    ``pad_mask`` [B, S] (True = real token) reaches only the MoE router's
    capacity accounting: attention is causal, so pad rows never feed real
    ones, and the serving scatter drops padded cache positions.
    ``constrain`` and ``q_pad`` place the attention on a mesh (module
    docstring)."""
    cache = None
    h = norm(p["mixer_norm"], x, cfg.norm_type)
    if mixer.startswith("attn"):
        q, k, v = attn_mod.project_qkv(p["mixer"], h, cfg, positions)
        o = attend_seq(q, k, v, window=window, cap=cfg.attn_logit_softcap,
                       constrain=constrain, q_pad=q_pad)
        o = dense(p["mixer"]["wo"], o.reshape(x.shape[0], x.shape[1], -1),
                  mode=cfg.matmul_mode)
        if write_cache:
            B, S = x.shape[:2]
            kvq = kv_spec(cfg)
            total = max(cache_len or S, S)
            cache = attn_mod.init_kv_cache(cfg, B, min(total, window) if window else total,
                                           k.dtype, kvq=kvq, device=x.device)
            attn_mod.write_cache_prefill(cache, k, v, window=window, kvq=kvq)
    else:
        o, cache = ssm_mod.ssm_block(p["mixer"], h, cfg, constrain=constrain,
                                     tail=write_cache)
    x = x + _post(p, "post_mixer_norm", o, cfg)
    if ffn is None:
        return x, cache, {}
    h = norm(p["ffn_norm"], x, cfg.norm_type)
    o, aux = _ffn(p, h, cfg, ffn, pad_mask, constrain)
    return x + _post(p, "post_ffn_norm", o, cfg), cache, aux


def apply_layer_prefill_chunk(p, x, cache, chunk_start: int, *, cfg):
    """One layer over one chunk of a chunked prefill.  x [B,C,D] holds C
    consecutive prompt rows from absolute position ``chunk_start``;
    ``cache`` is this layer's dense bf16 workspace {"k","v": [B,Sb,K,Dh],
    "pos": [Sb]}, already holding every earlier chunk.  Writes the chunk's
    K/V in place, attends over the workspace and runs the same row-wise
    math as ``apply_layer_seq``.  Returns x.  Full attention only: a
    window breaks the workspace's row-is-position layout."""
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
    x = x + _post(p, "post_mixer_norm", o, cfg)
    if "ffn" not in p:
        return x
    h = norm(p["ffn_norm"], x, cfg.norm_type)
    return x + _post(p, "post_ffn_norm", mlp(p["ffn"], h, cfg), cfg)


def local_decode_attn(q, k_new, v_new, cache, pos, *, cap=0.0, window=0, kvq=None):
    """Write one token's K/V into a slot cache (its ring slot in a windowed
    layer), in place, and attend over it: q [B,H,Dh], k_new/v_new [B,K,Dh].
    Returns the attention output [B,H,Dh]."""
    attn_mod.write_cache_decode(cache, k_new, v_new, pos, window=window, kvq=kvq)
    return attn_mod.decode_attention(q, cache, pos, cap=cap, window=window, kvq=kvq)


def apply_layer_decode(p, x, cache, pos: torch.Tensor, *, cfg, mixer="attn", window=0,
                       ffn="mlp", decode_attn=local_decode_attn, constrain=NO_CONSTRAIN):
    """Single-token mode.  x [B,D]; pos a 0-d (shared) or [B] (a position a
    row, -1 = idle) int32 tensor.  ``decode_attn`` writes this token into
    ``cache`` in place and attends; an SSM layer advances its state and conv
    in place (every row, as the reference: an idle row's state is junk
    until a prefill or a restore overwrites it).  An MoE position masks idle
    rows (their hidden states are junk) out of its capacity, so they cannot
    crowd real rows' expert slots; a shared position leaves every row in.
    On a mesh ``constrain`` places the SSM and MoE layers (the sharder's)
    and ``decode_attn`` is the sharder's read.  Returns x."""
    h = norm(p["mixer_norm"], x, cfg.norm_type)
    if mixer.startswith("attn"):
        # RoPE positions [..., seq]: [1] broadcasts over the batch, [B, 1]
        # rotates each row by its own position
        positions = pos[:, None] if pos.ndim else pos[None]
        q, k, v = attn_mod.project_qkv(p["mixer"], h[:, None, :], cfg, positions)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        o = decode_attn(q, k, v, cache, pos, cap=cfg.attn_logit_softcap, window=window,
                        kvq=kv_spec(cfg))
        o = dense(p["mixer"]["wo"], o.reshape(x.shape[0], -1), mode=cfg.matmul_mode)
    else:
        o = ssm_mod.ssm_block_decode(p["mixer"], h, cache, cfg, constrain=constrain)
    x = x + _post(p, "post_mixer_norm", o, cfg)
    if ffn is None:
        return x
    h = norm(p["ffn_norm"], x, cfg.norm_type)
    if ffn == "moe":
        pm = (pos >= 0)[:, None] if pos.ndim else None
        o, _ = moe_mod.moe_ffn(p["ffn"], h[:, None, :], cfg, pm, decode=True,
                               constrain=constrain)
        o = o[:, 0]
    else:
        o = mlp(p["ffn"], h, cfg)
    return x + _post(p, "post_ffn_norm", o, cfg)


def init_stack(init, cfg) -> list:
    """Stacked params: one entry a period position whose leaves carry a
    leading n_periods axis."""
    sched = stack_schedule(cfg)
    return [init_layer(init.stacked(cfg.n_layers // len(sched)), mixer, ffn, cfg)
            for mixer, ffn in sched]


def apply_stack_seq(stack, x, cfg, *, positions, cache_len=None, write_cache=False,
                    pad_mask=None, constrain=NO_CONSTRAIN, q_pad=None, remat=False):
    """All layers in sequence mode.  Returns (x, caches, aux_sum): caches is
    a tuple of dicts, one a period position, stacked over periods, as the
    reference's; aux_sum the MoE layers' aux losses (0.0 without any).
    ``remat`` (under autograd, without caches) runs each period's body
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(
    period_body)``): only its input is kept, and the backward runs it
    again, a stacked weight's selection and gathers included, in the same
    order on every rank."""
    sched = stack_schedule(cfg)
    caches = [[] for _ in stack]

    def period_body(x, aux_sum, p):
        out = []
        for j, (mixer, ffn) in enumerate(sched):
            x, cache, aux = apply_layer_seq(take(stack[j], p), x, cfg=cfg, positions=positions,
                                            mixer=mixer, window=mixer_window(mixer, cfg),
                                            cache_len=cache_len, write_cache=write_cache,
                                            ffn=ffn, pad_mask=pad_mask, constrain=constrain,
                                            q_pad=q_pad)
            out.append(cache)
            aux_sum = aux_sum + aux.get("moe_aux", 0.0)
        return x, out, aux_sum

    ckpt = remat and not write_cache and torch.is_grad_enabled()
    aux_sum = 0.0
    for p in range(cfg.n_layers // len(sched)):
        if ckpt:
            x, out, aux_sum = recompute_in_backward(period_body, x, aux_sum, p)
        else:
            x, out, aux_sum = period_body(x, aux_sum, p)
        for j, cache in enumerate(out):
            caches[j].append(cache)
    if not write_cache:
        return x, None, aux_sum
    return (x, tuple({k: torch.stack([c[k] for c in cs]) for k in cs[0]} for cs in caches),
            aux_sum)


def recompute_in_backward(fn, *args):
    """``fn(*args)``, keeping only its inputs for the backward, which runs
    ``fn`` again (``torch.utils.checkpoint``, non-reentrant).  The forward
    draws no random numbers, so the RNG state is not kept (on the card
    reading it would wait for the device), and it runs the same shapes
    again, so the recomputed tensors' metadata is not checked."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False,
                                             determinism_check="none")


def apply_stack_prefill_chunk(stack, x, caches, chunk_start: int, cfg):
    """All layers over one prefill chunk; ``caches`` is a dense bf16
    workspace in init_stack_cache's layout, updated in place.  Returns
    (x, caches)."""
    for p, j, i, mixer, window, ffn in _layers(stack, cfg):
        if mixer != "attn" or window or ffn == "moe":
            raise ValueError(f"{cfg.name}: chunked prefill supports full attention and "
                             "dense MLPs only")
        x = apply_layer_prefill_chunk(p, x, take(caches[j], i), chunk_start, cfg=cfg)
    return x, caches


def apply_stack_decode(stack, x, caches, pos: torch.Tensor, cfg, *,
                       decode_attn=local_decode_attn, constrain=NO_CONSTRAIN):
    """All layers in decode mode at ``pos`` (a 0-d or [B] int32 tensor);
    ``caches`` (init_stack_cache's layout) are updated in place through
    ``decode_attn`` and the SSM layers.  Returns (x, caches)."""
    for p, j, i, mixer, window, ffn in _layers(stack, cfg):
        x = apply_layer_decode(p, x, take(caches[j], i), pos, cfg=cfg, mixer=mixer,
                               window=window, ffn=ffn, decode_attn=decode_attn,
                               constrain=constrain)
    return x, caches


def init_stack_cache(cfg, batch: int, cache_len: int, dtype=None, *, per_slot: bool = False,
                     device=None):
    """Empty caches in apply_stack_decode's layout, one dict a period
    position (``per_slot``: a position array a row); a windowed position's
    ring holds min(cache_len, window) slots, an SSM position its state
    (f32) and conv tail (``dtype``)."""
    sched = stack_schedule(cfg)
    n_periods = cfg.n_layers // len(sched)
    dtype = dtype or torch.bfloat16
    caches = []
    for mixer, _ in sched:
        if mixer == "ssm":
            one = ssm_mod.init_ssm_cache(cfg, batch, dtype, device=device)
        else:
            w = mixer_window(mixer, cfg)
            one = attn_mod.init_kv_cache(cfg, batch, min(cache_len, w) if w else cache_len,
                                         dtype, kvq=kv_spec(cfg), per_slot=per_slot,
                                         device=device)
        caches.append({k: v.unsqueeze(0).repeat((n_periods,) + (1,) * v.ndim)
                       for k, v in one.items()})
    return tuple(caches)
