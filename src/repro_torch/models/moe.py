"""Mixture-of-experts FFN with capacity-based scatter dispatch — port of
``repro/models/moe.py``.

Dispatch is scatter/gather, as in the reference: each (token, choice) gets
a position in its expert from an exclusive cumulative count, tokens are
scattered into per-group expert buffers [G, E, C + 1, D] (row C takes the
overflow, which is dropped), the experts multiply their buffers, and each
token gathers its k outputs weighted by its renormalised gates.  The router
runs in f32 (its weight stays f32 and unquantized); the expert stacks are
the paper's memory-bound sweet spot.

The expert products follow ``cfg.matmul_mode`` where every stack is a
row-structured QuantizedTensor (``experts_fused_eligible``):

* a decode (``decode=True``) whose capacity buffers hold at most
  ``qmatmul.GEMV_MAX_M`` rows goes through one expert-batched launch of the
  tensor-core GEMV a matrix kind (``qmatmul.qmatmul_experts``), the rows an
  expert holds read from device memory, so a captured step routes on the
  card with no host sync;
* a sequence (prefill) sends each expert's G * C rows through the prefill
  GEMM (``qmatmul.qmatmul_gemm``), one launch an expert that holds a token
  and a matrix, whatever the row count, so a row's product does not depend
  on the bucket a prompt was padded to;
* "dequant_einsum", and stacks the kernels do not take, dequantize the
  stacks (``_materialize``) and multiply in f32, rounded to the activation
  dtype, as the reference's bf16 einsum on the CPU: the oracle.

On the CPU the kernels' plain versions run.  Expert rows that hold no token
are not written by the GEMV; the combine gathers only kept (expert, slot)
pairs and takes 0 for dropped ones (the reference's zero row C), so such
rows never reach a result.

``_n_groups`` and ``capacity`` are the reference's: an unmasked call of
T >= 256 tokens with T % 16 == 0 runs 16 dispatch groups of consecutive
tokens, each with its own capacity; a masked call (``pad_mask``) runs one,
its capacity the f32 twin of ``capacity`` on the real tokens' count, so a
bucket-padded prefill keeps and drops what the exact-length one does when
that one runs one group.

On a mesh (``constrain``, ``models/sharding.py``) the layer is expert
parallel: the expert stacks are ``kernels/ops.Placed`` slices of this
rank's E / tp experts.  Routing, capacity and positions are computed on the
whole tokens, alike on every rank of a model group; the rank multiplies its
experts' buffers (``expert_buffer4``, the counts alike) and the outputs are
all-gathered on E before the combine, which is the unsharded one, so a
sharded serving forward equals the unsharded one on the same input.  In a
train step the batch's rows are split over the data axes: the groups
(``_n_groups``) are those of the global batch, and where a rank's rows are
not whole groups (one group: fewer than 256 tokens, or a pad mask) the
tokens are all-gathered over the data axes, dispatched as the unsharded
run dispatches them (the same capacity and drops) and this rank's rows
taken back.  The aux loss is the global one on every rank, its gradient
shared out over the data ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.qtensor import QuantizedTensor, dequantize_tensor
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as qk
from repro_torch.models.layers import NO_CONSTRAIN, activation, linear
from repro_torch.utils import cost

#: the expert stacks' keys, in the reference's order
MOE_WEIGHTS = ("w_gate", "w_up", "w_down")


def _materialize(w, dtype):
    """Dense [E, in, out] view of an expert stack (QT stores [E, out, in])."""
    w = _local(w)
    if isinstance(w, QuantizedTensor):
        return dequantize_tensor(w, out_dtype=dtype).swapaxes(-1, -2)
    return w.to(dtype)


def init_moe(init, cfg) -> dict:
    """The router (f32 whatever the init's dtype, as the reference keeps it)
    and the three expert stacks [E, in, out]."""
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_out = D**-0.5, Fd**-0.5
    return {
        "router": init.normal((D, E), s_in, dtype=torch.float32),
        "w_gate": init.normal((E, D, Fd), s_in),
        "w_up": init.normal((E, D, Fd), s_in),
        "w_down": init.normal((E, Fd, D), s_out),
    }


def _local(w):
    """An expert stack as this rank holds it: a ``Placed`` slice's experts
    (``blocks.take`` gathered them over "data"), else the stack itself."""
    return w.local if isinstance(w, ops.Placed) else w


def capacity(n_tokens: int, cfg) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8, as the reference


def _n_groups(T: int) -> int:
    """The reference's dispatch groups: 16 for T >= 256 with T % 16 == 0."""
    return 16 if T % 16 == 0 and T >= 256 else 1


def experts_fused_eligible(w) -> bool:
    """Can this layer's expert stack go through the kernels?  Row-structured
    [E, N, K] storage, no means, no outliers."""
    w = _local(w)
    return (isinstance(w, QuantizedTensor) and w.structured and len(w.quant_shape) == 2
            and w.packed.ndim == 3 and w.means is None and w.outlier_idx is None)


def route(params, xt: torch.Tensor, cfg):
    """The router over xt [G, Tg, D]: (probs [G, Tg, E] f32, renormalised
    gates [G, Tg, k] f32, expert ids [G, Tg, k] int64), the reference's
    f32 softmax and top-k (ties to the lower id)."""
    logits = linear(xt, params["router"]).to(torch.float32)
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    # a stable sort: equal probabilities (bf16 logits tie often) keep the
    # lower id first, as jax.lax.top_k; torch.topk does not promise an order
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[..., :cfg.top_k], expert_idx[..., :cfg.top_k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_idx


def _f32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [G, E, C, in] times dense experts w [E, in, out], summed in f32 and
    rounded to a's dtype."""
    return torch.einsum("gecd,edf->gecf", a.to(torch.float32),
                        w.to(torch.float32)).to(a.dtype)


def _gemm_rows_work(x: torch.Tensor, w: QuantizedTensor) -> dict:
    """B1's charge (``kernels/ops.qmatmul``'s) for one expert's rows."""
    return ops.qmatmul_work(x, ops.operand_from_qtensor(w))


@cost.unit(_gemm_rows_work)
def _gemm_rows(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x [M, K] times one expert's matrix: the prefill GEMM on the card
    (whatever M), its plain version on the CPU."""
    op = ops.operand_from_qtensor(w)
    xp, packed, scales = ops.pad_for_kernel(x, op)
    launch = qk.qmatmul_gemm if x.is_cuda else qk.qmatmul_plain
    return launch(xp, packed, scales, op.codebook, bits=op.bits, block_size=op.block_size)


def _experts_batched(params, work, counts, cfg):
    """work [E, M, D] (M <= GEMV_MAX_M, experts at any stride) through one
    expert-batched GEMV a matrix kind; counts [E] int32 on the device.
    Returns [E, M, D]; rows at or past an expert's count are no result."""

    def product(x, w):
        w = _local(w)
        return qk.qmatmul_experts(x, w.packed, w.scales, w.codebook, counts, bits=w.bits,
                                  block_size=w.block_size)

    if work.stride(0) % 8:   # the kernel takes experts 16 bytes apart
        work = work.contiguous()
    h = activation(product(work, params["w_gate"]), cfg.act) * product(work, params["w_up"])
    return product(h, params["w_down"])


def _experts_per_expert(params, work, active, cfg):
    """work [G, E, C, D]: each expert in ``active`` multiplies its G * C rows
    through ``_gemm_rows``.  Returns [G, E, C, D]; the other experts' rows
    are no result."""
    G, E, C, D = work.shape
    out = torch.empty_like(work)
    for e in active:
        def w(key, e=e):
            return _local(params[key]).select(e)

        x = work[:, e].reshape(G * C, D)
        h = activation(_gemm_rows(x, w("w_gate")), cfg.act) * _gemm_rows(x, w("w_up"))
        out[:, e] = _gemm_rows(h, w("w_down")).reshape(G, C, D)
    return out


def _experts(params, work, counts, cfg, *, decode: bool):
    """The experts on their buffers work [G, E, C, D] -> [G, E, C, D] (E:
    the experts this rank holds)."""
    G, E, C, D = work.shape
    held = _local(params["w_gate"]).shape[-3]
    if held != E:
        raise ValueError(f"{E} expert buffers against a stack of {held} experts: a sharded "
                         "expert stack needs its sharder's constrain")
    if cfg.matmul_mode != "dequant_einsum" and all(
            experts_fused_eligible(params[k]) for k in MOE_WEIGHTS):
        if decode and G * C <= qk.GEMV_MAX_M:
            return _experts_batched(params, work[0], counts[0], cfg)[None]
        # a decode past the GEMV's rows multiplies every expert (no host read
        # inside a captured step); a prefill only those that hold a token
        active = range(E) if decode else torch.nonzero(counts.sum(0)).flatten().tolist()
        return _experts_per_expert(params, work, active, cfg)
    w_gate, w_up, w_down = (_materialize(params[k], work.dtype) for k in MOE_WEIGHTS)
    h = activation(_f32_product(work, w_gate), cfg.act) * _f32_product(work, w_up)
    return _f32_product(h, w_down)


def moe_ffn(params, x: torch.Tensor, cfg, pad_mask=None, *, decode: bool = False,
            constrain=NO_CONSTRAIN):
    """x [B, S, D] -> (y [B, S, D], {"moe_aux": Switch loss}); a decode
    (``decode=True``, S = 1) skips the aux loss and returns {}.

    ``pad_mask`` [B, S] bool (True = real token) keeps padding out of the
    router's capacity accounting, as in the reference: pads claim no
    (expert, slot), the capacity is the traced ``capacity(n_real)``
    clamped to the padded length's static buffer, and pads' combine
    weights and aux contributions are zero.  A masked call runs one
    dispatch group.  ``constrain``: the sharder's (module docstring)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    d_idx, d_n = constrain.batch_share()
    G = 1 if pad_mask is not None else _n_groups(B * S * d_n)   # the global batch's
    whole = d_n > 1 and G % d_n != 0
    if whole:   # this rank's rows are not whole groups: dispatch the whole batch
        x = constrain.batch_whole(x)
        if pad_mask is not None:
            pad_mask = constrain.batch_whole(pad_mask.to(torch.uint8)).bool()
    elif d_n > 1:   # this rank's rows are G / d_n whole groups
        G //= d_n
    T = x.shape[0] * S
    Tg = T // G
    dev = x.device
    xt = x.reshape(G, Tg, D)
    mask = None if pad_mask is None else pad_mask.reshape(G, Tg)

    probs, gate_vals, expert_idx = route(params, xt, cfg)

    # per-group position of each (token, choice) within its expert
    C = capacity(Tg, cfg)
    onehot = F.one_hot(expert_idx, E).to(torch.int32)                 # [G, Tg, k, E]
    if mask is not None:
        # pads never claim an (expert, slot)
        onehot = onehot * mask[..., None, None].to(torch.int32)
    flat = onehot.reshape(G, Tg * k, E)
    pos_in_expert = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = (pos_in_expert * flat).sum(dim=-1, dtype=torch.int32).reshape(G, Tg, k)
    if mask is None:
        c_lim = torch.full((G, 1), C, dtype=torch.int32, device=dev)
    else:
        # the f32 twin of capacity(n_real): the exact-length run's capacity
        n_real = mask.sum(dim=1).to(torch.float32)                        # [G]
        c_dyn = torch.floor(cfg.capacity_factor * cfg.top_k * n_real / E).to(torch.int32)
        c_dyn = torch.clamp(-torch.div(-c_dyn, 8, rounding_mode="floor") * 8, min=8)
        c_lim = torch.clamp(c_dyn, max=C)[:, None]                       # static buffer bound
    keep = pos < c_lim[..., None]  # dropped beyond capacity (standard switch behaviour)
    if mask is not None:
        keep = keep & mask[..., None]
    # rows an expert holds: its kept positions are 0 .. count - 1
    counts = torch.minimum(flat.sum(dim=1, dtype=torch.int32), c_lim)   # [G, E]

    # dispatch: per-group scatter into expert buffers [G, E, C + 1, D]
    e_flat = expert_idx.reshape(G, Tg * k)
    p_flat = torch.where(keep, pos, C).reshape(G, Tg * k).to(torch.int64)
    tok_id = torch.arange(Tg, device=dev)[:, None].expand(Tg, k).reshape(-1)
    g_id = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    buf = torch.zeros((G, E, C + 1, D), dtype=x.dtype, device=dev)
    buf.index_put_((g_id, e_flat, p_flat), xt[:, tok_id])
    # this rank's experts (and groups, over the data axes in serving) on
    # their buffers, the outputs gathered whole
    work = buf[:, :, :C]
    out = _experts(params, constrain(work, "expert_buffer4"),
                   constrain(counts, "expert_counts"), cfg, decode=decode)
    out = constrain.gather(out, "expert_buffer4", work.shape)             # [G, E, C, D]

    # combine: each token's kept (expert, slot) outputs, weighted by its gates
    kept = keep.reshape(G, Tg * k)
    slot = e_flat * C + torch.clamp(p_flat, max=C - 1)
    gathered = torch.gather(out.reshape(G, E * C, D), 1, slot[..., None].expand(G, Tg * k, D))
    gathered = torch.where(kept[..., None], gathered, torch.zeros((), dtype=x.dtype, device=dev))
    w = torch.where(keep, gate_vals, 0.0).to(x.dtype)
    prod = (gathered.reshape(G, Tg, k, D) * w[..., None]).to(torch.float32)
    # the k weighted outputs summed in f32 in choice order, one add at a
    # time: XLA's order on the CPU, and on the card an order that does not
    # depend on how many tokens share the call (a reduction kernel's split
    # may), so a row decodes alike in the Server's pool and the batch-1 Engine
    y = prod[:, :, 0]
    for j in range(1, k):
        y = y + prod[:, :, j]
    y = y.to(x.dtype).reshape(-1, S, D)
    if whole:
        y = y.narrow(0, d_idx * B, B)
    if decode:
        return y, {}

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e
    top1 = F.one_hot(expert_idx[..., 0].reshape(-1), E).to(torch.float32)
    flat_probs = probs.reshape(-1, E)
    if mask is None:
        frac_tokens = torch.mean(top1, dim=0)
        frac_probs = torch.mean(flat_probs, dim=0)
    else:
        mf = mask.reshape(-1, 1).to(torch.float32)
        denom = torch.clamp(torch.sum(mf), min=1.0)
        frac_tokens = torch.sum(top1 * mf, dim=0) / denom
        frac_probs = torch.sum(flat_probs * mf, dim=0) / denom
    if d_n > 1 and not whole:   # this rank's groups: the fractions summed over the data ranks
        frac_tokens = constrain.batch_sum(frac_tokens / d_n)
        frac_probs = constrain.batch_sum(frac_probs / d_n)
    aux = E * torch.sum(frac_tokens * frac_probs)
    if whole:
        # every data rank holds the global aux: its gradient, 1 / d_n on
        # each, is summed by the token gather's adjoint
        aux = aux.detach() + (aux - aux.detach()) / d_n
    return y, {"moe_aux": aux}


def moe_ffn_quantized_weights(params):
    """Leaves that the quantizer should treat as expert matrices."""
    return list(MOE_WEIGHTS)
