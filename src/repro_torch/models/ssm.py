"""Mamba-2 / SSD (state-space duality) selective state-space block — port of
``repro/models/ssm.py``.

Used by mamba2-130m (every layer) and jamba-v0.1 (7 of every 8 layers; the
reference realizes Jamba's Mamba-1 layers with the SSD formulation of the
same selective-SSM family, ``configs/jamba_v01_52b.py``).

Prefill uses the chunked SSD algorithm (quadratic within chunks of length
Q, linear across chunks: the reference's ``lax.scan`` over chunks is a
Python loop here); decode is the O(1) recurrence

    h_t = h_{t-1} * exp(dt_t A) + dt_t * (B_t x_t^T) ;  y_t = C_t . h_t + D x_t

``ssd_reference`` is the per-step oracle the chunked path is held against.
The reference computes all of this in jnp, outside any Pallas kernel, so it
is plain PyTorch here; its projections (``in_proj``, ``out_proj``) go
through ``layers.dense`` and so through the fused dequant-GEMM when
quantized.

Numerics kept from the reference: softplus is ``logaddexp(x, 0)`` (not
``F.softplus``, which returns x above 20); the prefill conv adds its
``ssm_conv`` shifted products in order, then ``conv_b``, in f32, and so does
the decode conv; groups broadcast to heads as ``jnp.repeat``
(``repeat_interleave``); the gated norm multiplies in the activation dtype.
The decode step's state update and read are elementwise products and one
sum over the state axis, so a row's result does not depend on how many rows
share the step (the Server's pool of 8 against the Engine's batch of 1).

On a mesh (``constrain``, ``models/sharding.py``) the SSD's heads are split
over "model": ``in_proj`` is column-parallel and ``out_proj`` row-parallel
(``layers.linear``); the depthwise conv runs on this rank's channels
(``conv_w`` and the conv cache are cut on them) and is all-gathered; the SSD
runs on this rank's heads (``ssm_heads``, ``ssm_dt``, with B and C whole,
``ssm_bc``, and the state cache cut on its heads), and y is gathered whole
before the gated RMSNorm, which runs over all of d_inner.  Heads or
channels that "model" does not divide stay whole on every rank.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import NO_CONSTRAIN, activation, dense, rmsnorm

F32 = torch.float32


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def in_proj_dim(cfg) -> int:
    # [z, x, B, C, dt]
    return 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.n_ssm_heads


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """f32 ``jnp.linspace(start, stop, num)`` as XLA evaluates it:
    start * (1 - i * r) + i * (stop * r) with r = 1 / (num - 1), the last
    point ``stop`` (torch.linspace rounds differently)."""
    start_t, stop_t = torch.tensor(start, dtype=F32), torch.tensor(stop, dtype=F32)
    if num == 1:
        return start_t.reshape(1)
    r = torch.tensor(1.0, dtype=F32) / torch.tensor(num - 1, dtype=F32)
    i = torch.arange(num - 1, dtype=F32)
    head = start_t * (1 - i * r) + i * (stop_t * r)
    return torch.cat([head, stop_t.reshape(1)])


def fixed_leaves(n_heads: int) -> dict:
    """The leaves ``init_ssm`` does not draw, on the host in f32: A_log,
    D and dt_bias.  Their log and expm1 are taken in f64 and rounded once
    (XLA's f32 approximations round some of them one ulp elsewhere)."""
    return {
        "A_log": torch.log(_linspace(1.0, 16.0, n_heads).double()).to(F32),
        "D": torch.ones((n_heads,), dtype=F32),
        "dt_bias": torch.log(torch.expm1(_linspace(1e-3, 1e-1, n_heads).double())).to(F32),
    }


def init_ssm(init, cfg) -> dict:
    """The reference's leaves and scales (``layers.Init``'s draws)."""
    D = cfg.d_model
    fixed = fixed_leaves(cfg.n_ssm_heads)
    return {
        "in_proj": init.dense(D, in_proj_dim(cfg)),
        "conv_w": init.normal((cfg.ssm_conv, conv_dim(cfg)), cfg.ssm_conv ** -0.5, dtype=F32),
        "conv_b": init.zeros((conv_dim(cfg),)),
        "A_log": init.const(fixed["A_log"]),
        "D": init.const(fixed["D"]),
        "dt_bias": init.const(fixed["dt_bias"]),
        "norm": {"scale": init.zeros((cfg.d_inner,))},
        "out_proj": init.dense(cfg.d_inner, D, scale=cfg.d_inner ** -0.5),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.where(torch.isnan(x), x,
                       torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs())))


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------

def _heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Groups to heads, f32: ``jnp.repeat`` along ``dim`` (each group's
    heads adjacent, as ``repeat_interleave``), by a broadcast that reads
    nothing on the host (a captured step holds it)."""
    t = t.to(F32).unsqueeze(dim + 1)
    shape = list(t.shape)
    shape[dim + 1] = rep
    return t.expand(shape).flatten(dim, dim + 1)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan.  x [B,S,H,P]; dt [B,S,H] (post-softplus); A [H]
    (negative); Bm, Cm [B,S,G,N].  Returns y [B,S,H,P] and the final state
    [B,H,P,N], both f32.  S must be a multiple of min(chunk, S), as the
    reference asserts: a prompt is never padded to a chunk."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} must be divisible by ssd chunk {Q}")
    n = S // Q

    xc = x.reshape(Bb, n, Q, H, P).to(F32)
    dtc = dt.reshape(Bb, n, Q, H).to(F32)
    Bh = _heads(Bm.reshape(Bb, n, Q, G, N), rep, 3)   # [B,n,Q,H,N]
    Ch = _heads(Cm.reshape(Bb, n, Q, G, N), rep, 3)

    la = dtc * A                      # log decay a step, <= 0
    cs = torch.cumsum(la, dim=2)      # inclusive within the chunk

    # intra-chunk (diagonal) term: seg [B,n,q,s,H] = cs_q - cs_s, causal
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    seg = seg.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    CB = torch.einsum("bnqhN,bnshN->bnqsh", Ch, Bh)
    W = CB * torch.exp(seg) * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bnqsh,bnshp->bnqhp", W, xc)

    # chunk-final states: sum_j exp(cs_Q - cs_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)   # [B,n,Q,H]
    state_chunk = torch.einsum("bnqh,bnqhN,bnqhp->bnhpN", decay_to_end * dtc, Bh, xc)

    # inter-chunk recurrence, keeping the state that enters each chunk
    chunk_decay = torch.exp(cs[:, :, -1, :])           # [B,n,H]
    h = (torch.zeros((Bb, H, P, N), dtype=F32, device=x.device) if initial_state is None
         else initial_state.to(F32))
    h_prevs = []
    for c in range(n):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + state_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)               # [B,n,H,P,N]

    # inter-chunk (off-diagonal) contribution
    y_off = torch.einsum("bnqhN,bnhpN->bnqhp", Ch, h_prevs) * torch.exp(cs)[..., None]
    return (y_diag + y_off).reshape(Bb, S, H, P), h


def ssd_reference(x, dt, A, Bm, Cm, initial_state=None):
    """The per-step recurrence (the oracle of the tests)."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh, Ch = _heads(Bm, rep, 2), _heads(Cm, rep, 2)
    h = (torch.zeros((Bb, H, P, N), dtype=F32, device=x.device) if initial_state is None
         else initial_state.to(F32))
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(F32)
        dec = torch.exp(dt_t * A)
        h = h * dec[:, :, None, None] + torch.einsum("bh,bhN,bhp->bhpN", dt_t, Bh[:, t],
                                                     x[:, t].to(F32))
        ys.append(torch.einsum("bhN,bhpN->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One token's recurrence.  state [B,H,P,N]; x_t [B,H,P]; dt_t [B,H];
    B_t, C_t [B,G,N] -> y [B,H,P], the new state (f32).  Elementwise
    products and one sum over N, so each row's bits are the same at any
    batch."""
    H, G = x_t.shape[1], B_t.shape[1]
    rep = H // G
    Bh, Ch = _heads(B_t, rep, 1), _heads(C_t, rep, 1)
    dt = dt_t.to(F32)
    dec = torch.exp(dt * A)
    upd = (dt[:, :, None] * Bh)[:, :, None, :] * x_t.to(F32)[..., None]
    state = state * dec[:, :, None, None] + upd
    y = (Ch[:, :, None, :] * state).sum(dim=-1)
    return y, state


# --------------------------------------------------------------------------
# full block (prefill and decode)
# --------------------------------------------------------------------------

def _split_in_proj(zxbcdt, cfg):
    Di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :Di]
    xbc = zxbcdt[..., Di: Di + Di + 2 * G * N]
    dt = zxbcdt[..., Di + Di + 2 * G * N:]
    return z, xbc, dt


def _split_conv_out(xbc, cfg):
    Di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return xbc[..., :Di], xbc[..., Di: Di + G * N], xbc[..., Di + G * N:]


def _conv_taps(rows, w, b):
    """sum_i rows[i] * w[i], added in order, then the bias, in f32 (the
    reference's Python sum); ``rows`` yields the taps' f32 inputs.
    Elementwise, so a row's bits do not depend on its batch."""
    out = None
    for i, r in enumerate(rows):
        out = r * w[i] if out is None else out + r * w[i]
    return out + b


def _conv_params(params, constrain):
    """(conv_w, conv_b) over this rank's channels, f32: conv_w as placed
    (a ``Placed`` slice's own), conv_b whole and cut alike."""
    w = params["conv_w"]
    w = w.local if isinstance(w, ops.Placed) else w
    return w.to(F32), constrain(params["conv_b"], "ssm_vec").to(F32)


def _ssd_inputs(params, x, dt, Bm, Cm, constrain):
    """This rank's part of the SSD's inputs (whole x [B,S,H,P], dt [B,S,H]
    pre-softplus, Bm and Cm [B,S,G,N]): (x, dt post-softplus, A, D, Bm, Cm)
    on its heads, B and C whole; groups of several heads are broadcast to
    the heads first where the heads are split (each of this rank's heads
    then reads its own group)."""
    H, G = x.shape[2], Bm.shape[2]
    dt = constrain(softplus(dt.to(F32) + params["dt_bias"].to(F32)), "ssm_dt")
    A = constrain(-torch.exp(params["A_log"].to(F32)), "ssm_vec")
    D = constrain(params["D"].to(F32), "ssm_vec")
    if G > 1 and A.shape[0] != H:
        Bm, Cm = _heads(Bm, H // G, 2), _heads(Cm, H // G, 2)
        Bm, Cm = constrain(Bm, "ssm_heads"), constrain(Cm, "ssm_heads")
    else:
        Bm, Cm = constrain(Bm, "ssm_bc"), constrain(Cm, "ssm_bc")
    return constrain(x, "ssm_heads"), dt, A, D, Bm, Cm


def _gated_out(params, y, z, dtype, cfg):
    """rmsnorm(y * silu(z)) in the activation dtype, then out_proj."""
    y = rmsnorm(y.to(dtype) * activation(z.to(F32), "silu").to(dtype), params["norm"]["scale"])
    return dense(params["out_proj"], y, mode=cfg.matmul_mode)


def ssm_block(params, u, cfg, initial_state=None, *, constrain=NO_CONSTRAIN,
              tail: bool = True):
    """The Mamba-2 mixer in sequence mode: u [B,S,D] -> (y [B,S,D], the tail
    {"state": [B,H,P,N] f32, "conv": [B, ssm_conv - 1, conv_dim] in u's
    dtype}, whole) that decode continues from; None for the tail without
    ``tail`` (a train step's: on a mesh its state is not gathered).
    ``constrain``: the sharder's (module docstring)."""
    Bb, S, _ = u.shape
    H, P, G, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xbc, dt = _split_in_proj(dense(params["in_proj"], u, mode=cfg.matmul_mode), cfg)

    # depthwise causal conv over [x, B, C], on this rank's channels
    w, b = _conv_params(params, constrain)
    cw = w.shape[0]
    xp = torch.cat([xbc.new_zeros((Bb, cw - 1, xbc.shape[-1])), xbc], dim=1)
    xpf = constrain(xp, "ssm_conv").to(F32)
    conv = _conv_taps((xpf[:, i: i + S] for i in range(cw)), w, b)
    conv = activation(conv, "silu").to(u.dtype)
    conv = constrain.gather(conv, "ssm_conv", xbc.shape)

    x, Bm, Cm = _split_conv_out(conv, cfg)
    x = x.reshape(Bb, S, H, P)
    x, dt, A, D, Bm, Cm = _ssd_inputs(params, x, dt, Bm.reshape(Bb, S, G, N),
                                      Cm.reshape(Bb, S, G, N), constrain)
    if initial_state is not None:
        initial_state = constrain(initial_state, "ssm_state")
    y, h_final = ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk, initial_state)
    y = y + D[None, None, :, None] * x.to(F32)
    y = constrain.gather(y, "ssm_heads", (Bb, S, H, P))
    out = _gated_out(params, y.reshape(Bb, S, cfg.d_inner), z, u.dtype, cfg)
    if not tail:
        return out, None
    # the conv's tail for decode: the last cw - 1 pre-conv features
    return out, {"state": constrain.gather(h_final, "ssm_state", (Bb, H, P, N)),
                 "conv": xp[:, xp.shape[1] - (cw - 1):]}


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    return {
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)), dtype=dtype,
                            device=device),
    }


def ssm_block_decode(params, u_t, cache, cfg, *, constrain=NO_CONSTRAIN):
    """One token of the mixer: u_t [B,D] -> y [B,D].  ``cache``'s "state"
    and "conv" are updated in place (a layer's view of the stacked caches),
    so a captured step replays over them.  On a mesh (``constrain``) the
    cache is this rank's slice (``Sharder.shard_caches``): its rows, conv
    channels and state heads, which the step advances; the activations go
    through the sequence mode's kinds with a sequence of one."""
    Bb = u_t.shape[0]
    H, P, G, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    zxbcdt = dense(params["in_proj"], u_t[:, None, :], mode=cfg.matmul_mode)[:, 0]
    z, xbc, dt = _split_in_proj(zxbcdt, cfg)

    w, b = _conv_params(params, constrain)
    cw = w.shape[0]
    xl = constrain(xbc[:, None, :], "ssm_conv")
    hist = torch.cat([cache["conv"].to(F32), xl.to(F32)], dim=1)
    conv = _conv_taps((hist[:, i] for i in range(cw)), w, b)
    conv = activation(conv, "silu").to(u_t.dtype)
    cache["conv"].copy_(hist[:, 1:])
    conv = constrain.gather(conv[:, None], "ssm_conv", (Bb, 1, xbc.shape[-1]))[:, 0]

    x, Bm, Cm = _split_conv_out(conv, cfg)
    x, dt, A, D, Bm, Cm = _ssd_inputs(params, x.reshape(Bb, 1, H, P), dt[:, None],
                                      Bm.reshape(Bb, 1, G, N), Cm.reshape(Bb, 1, G, N),
                                      constrain)
    x = x[:, 0]
    y, state = ssd_decode_step(cache["state"], x, dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    cache["state"].copy_(state)
    y = y + D[None, :, None] * x.to(F32)
    y = constrain.gather(y[:, None], "ssm_heads", (Bb, 1, H, P))[:, 0]
    return _gated_out(params, y.reshape(Bb, cfg.d_inner), z, u_t.dtype, cfg)
