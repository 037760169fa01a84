"""Shared building blocks: norms, RoPE, activations and ``linear`` — port of
``repro/models/layers.py``.

``linear`` accepts a plain weight or a k-bit ``QuantizedTensor``.  For a
quantized weight ``cfg.matmul_mode`` picks the path: "fused" streams packed
codes and scales into the fused dequant-GEMM (``kernels/ops.fused_matmul``:
the CUDA kernel on the card); "dequant_einsum" materializes the weight in
the activation dtype and multiplies it, the numerical oracle.  Both round
the weight to the activation dtype and sum in f32, so they differ only in
summation order.  Dense weights are cast to the activation dtype, and the
product is summed in f32 and rounded to it, as the reference's bf16 einsum
is on the CPU.

On a mesh a weight is a ``kernels/ops.Placed`` slice, and ``linear`` runs it
by the reference's placement over the groups of the sharder it holds: a
quantized weight column-parallel on its output rows (B1 or the dequantized
rows on this rank, then an all-gather, ``ops.tp_column_parallel``); a dense
one of ``_COL_MODULES`` on its local columns, then an all-gather; a dense
one of ``_ROW_MODULES`` (split on its input rows) as this rank's slice of x
times its rows, summed in f32 and reduced over "model" (``all_reduce``)
before the rounding — the reference's GSPMD partial sum.  Each shard keeps
``matmul_rounded``'s fixed row pieces.  A train state's weight stored cut
over "data" (FSDP) is gathered first (``Placed.gathered``); under autograd
the collectives carry their adjoints (``kernels/ops.py``).
"""

from __future__ import annotations

import copy
import functools
import math

import torch

from repro_torch.core.qtensor import QuantizedTensor, dequantize_tensor
from repro_torch.kernels import ops
from repro_torch.utils import cost


class NoConstrain:
    """The unsharded placement (``models/sharding._Constrain``'s interface):
    every activation stays whole, and the batch is all here."""

    def __call__(self, x, kind: str):
        return x

    def gather(self, x, kind: str, shape):
        return x

    def batch_sum(self, x):
        return x

    def batch_share(self) -> tuple[int, int]:
        """(this rank's index, the number of ranks) over which the batch's
        rows are split."""
        return 0, 1

    def batch_whole(self, x):
        return x


#: the reference's NO_CONSTRAIN
NO_CONSTRAIN = NoConstrain()


def resolve_matmul_mode(mode: str, w) -> str:
    """Per-matrix dispatch decision: 'fused' or 'dequant_einsum'."""
    if mode == "dequant_einsum":
        return "dequant_einsum"
    if mode not in ("auto", "fused"):
        raise ValueError(f"unknown matmul_mode {mode!r}")
    return "fused" if ops.qt_fused_eligible(w) else "dequant_einsum"


#: rows of a dense product on the card in one cuBLAS call: calls of at most
#: ROW_PIECES[0] rows take one piece of that many, longer ones pieces of
#: ROW_PIECES[1] (see matmul_rounded)
ROW_PIECES = (16, 128)
#: weight rows (output columns) a dense product on the card converts to f32
#: and multiplies at a time, where the weight has more (a vocabulary head)
COL_PIECE = 16384


def _row_pieces(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x [M, K] f32 copied into zero-padded pieces of P rows: (the pieces'
    buffer [n * P, K], P)."""
    M, K = x.shape
    P = ROW_PIECES[0] if M <= ROW_PIECES[0] else ROW_PIECES[1]
    buf = torch.zeros((-(-M // P) * P, K), dtype=torch.float32, device=x.device)
    buf[:M].copy_(x)
    return buf, P


def _pieces_matmul(buf: torch.Tensor, P: int, w: torch.Tensor) -> torch.Tensor:
    """buf [n * P, K] @ w[N, K]^T, one cuBLAS call a piece of P rows."""
    wt = w.T
    return torch.cat([buf[i:i + P] @ wt for i in range(0, buf.shape[0], P)])


def _matmul_work(x: torch.Tensor, wt: torch.Tensor) -> dict:
    """The charge of a dense product: 2·M·N·K (the pieces' padding is no
    work); x and the weight as stored read, y written."""
    N, K = wt.shape
    M = x.numel() // K
    dot = 2 * M * N * K
    return dict(flops=dot, dot_flops=dot,
                hbm_bytes=cost.nbytes(x) + cost.nbytes(wt) + M * N * x.element_size())


@cost.unit(_matmul_work)
def matmul_rounded(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ wt[N, K]^T summed in f32, rounded to x's dtype
    (``matmul_f32``'s sums)."""
    return matmul_f32(x, wt).to(x.dtype)


def matmul_f32(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ wt[N, K]^T, wt rounded to x's dtype, summed in f32.

    On CUDA outside autograd every cuBLAS call has one fixed shape: the rows
    go in zero-padded pieces (``_row_pieces``), and a weight of more than
    ``COL_PIECE`` rows is converted to f32 and multiplied in pieces of that
    many rows, the last one zero-padded.  cuBLAS picks its algorithm, and so
    its summation order, by the shape of the call, so a row's result would
    otherwise depend on how many rows share it.  In pieces a decode row at
    batch 8 (the Server's pool) equals it at batch 1 (the Engine), and a
    bucket-padded prefill row its exact-length one, where a weight is dense
    (a plan's 16-bit unit, a tied head) or dequantized (``dequant_einsum``);
    and a 256,000-row head never has a whole f32 copy (4.7 GB at gemma2's)."""
    grad = torch.is_grad_enabled() and (x.requires_grad or wt.requires_grad)
    if not x.is_cuda or grad:
        return x.to(torch.float32) @ wt.to(x.dtype).to(torch.float32).T
    buf, P = _row_pieces(x.reshape(-1, x.shape[-1]).to(torch.float32))
    N, K = wt.shape
    piece = torch.zeros((min(N, COL_PIECE), K), dtype=torch.float32, device=x.device)
    outs = []
    for c0 in range(0, N, COL_PIECE):
        w = wt[c0:c0 + COL_PIECE]
        piece[:w.shape[0]].copy_(w.to(x.dtype))
        piece[w.shape[0]:].zero_()
        outs.append(_pieces_matmul(buf, P, piece)[:, :w.shape[0]])
    y = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    M = x.numel() // K
    return y[:M].reshape(x.shape[:-1] + (N,))


def _linear_placed(x: torch.Tensor, w: ops.Placed, bias, mode: str) -> torch.Tensor:
    """``linear`` on this rank's slice of a weight (module docstring)."""
    s = w.sharder
    w = w.gathered()
    if not w.tp_split():     # stored cut over "data" only: whole once gathered
        if isinstance(bias, ops.Placed):   # a bias is split over "model" alone
            bias = ops.gather_dim(bias.local, -1, s.group(s.tp))
        return linear(x, w.local, bias, mode=mode)
    local = bias.local if isinstance(bias, ops.Placed) else bias
    if isinstance(w.local, QuantizedTensor):
        if resolve_matmul_mode(mode, w.local) == "fused":
            op = ops.operand_from_qtensor(w.local)
            return ops.tp_column_parallel(x, lambda xl: ops.fused_matmul(xl, op), s, local)
        wt = dequantize_tensor(w.local, out_dtype=x.dtype)
        return ops.tp_column_parallel(x, lambda xl: matmul_rounded(xl, wt), s, local)
    if w.split_on(s.tp, -1):    # column-parallel [in, out / tp]
        return ops.tp_column_parallel(x, lambda xl: matmul_rounded(xl, w.local.T), s, local)
    # row-parallel [in / tp, out]: this rank's input slice, partial sums reduced
    r, _ = s.coord(s.tp)
    k = w.local.shape[0]
    y = matmul_f32(ops.fan_in(x, s.group(s.tp))[..., r * k:(r + 1) * k], w.local.T)
    y = ops.all_reduce(y.contiguous(), s.group(s.tp)).to(x.dtype)
    if isinstance(bias, ops.Placed):
        local = ops.gather_dim(bias.local, -1, s.group(s.tp))
    return y if local is None else y + local.to(y.dtype)


def linear(x: torch.Tensor, w, bias=None, *, mode: str = "dequant_einsum") -> torch.Tensor:
    """y = x @ w (+ bias).  ``w`` is [in, out], or a QuantizedTensor storing
    the weight as (out, in) with blocks along the reduction dim, or this
    rank's ``ops.Placed`` slice of either."""
    if isinstance(w, ops.Placed):
        return _linear_placed(x, w, bias, mode)
    if isinstance(w, QuantizedTensor):
        if resolve_matmul_mode(mode, w) == "fused":
            y = ops.fused_matmul(x, ops.operand_from_qtensor(w))
        else:
            y = matmul_rounded(x, dequantize_tensor(w, out_dtype=x.dtype))
    else:
        y = matmul_rounded(x, w.T)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


#: features a first-stage sum of ``rmsnorm`` takes
NORM_PIECE = 128


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis.  Where the width is a multiple of
    NORM_PIECE the mean square is summed in two fixed stages (pieces of
    NORM_PIECE, then the pieces): PyTorch's CUDA reduction then splits a
    row the same way however many rows share the call, so a row's norm on
    the card does not depend on its batch (a decode row at batch 8 equals
    it at batch 1)."""
    dt = x.dtype
    x = x.to(torch.float32)
    D = x.shape[-1]
    if D % NORM_PIECE == 0 and D > NORM_PIECE:
        sq = (x * x).reshape(x.shape[:-1] + (D // NORM_PIECE, NORM_PIECE))
        ms = sq.sum(dim=-1).sum(dim=-1, keepdim=True) / D
    else:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(ms + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32)) + bias.to(torch.float32)).to(dt)


def norm(params: dict, x: torch.Tensor, norm_type: str) -> torch.Tensor:
    if norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as jax.nn casts its constants to x's
    dtype (exact in f32, so a product with it rounds once, as XLA's)."""
    return float(torch.tensor(value, dtype=dtype))


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    """jax.nn's formulas, one op at a time in x's dtype — each op rounds,
    as XLA evaluates them (a fused F.silu rounds once and differs in the
    last bf16 bit for about a third of the values).  The tanh GELU takes
    jax.nn.gelu's order and constants in x's dtype: x * (0.5 * (1 +
    tanh(c * (x + 0.044715 * (x * x) * x)))), the cube two rounded
    products."""
    if act == "gelu":
        c = _in_dtype(0.7978845608028654, x.dtype)
        a = _in_dtype(0.044715, x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))
    return x * (1 / (1 + torch.exp(-x)))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit softcapping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotation.  x: [..., seq, heads, head_dim]; positions:
    [..., seq] (broadcastable)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x = x.to(torch.float32)
    x1, x2 = x[..., :half], x[..., half: 2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if x.shape[-1] > 2 * half:
        rot = torch.cat([rot, x[..., 2 * half:]], dim=-1)
    return rot.to(dt)


#: bytes of f32 a draw may hold at once: a larger stacked leaf (moonshot-v1's
#: [48, 64, 2048, 1408] expert stacks, 35 GB in f32) is drawn an item of its
#: leading axis at a time, straight into its storage
DRAW_PIECE_BYTES = 2**34


class Init:
    """Seeded parameter draws on one device: a ``torch.Generator`` stands
    in for the reference's ``jax.random`` keys (the two give different
    numbers).  Weights are drawn in f32 and stored in ``dtype``; the
    ``meta`` device gives shapes without data."""

    def __init__(self, seed: int, device: torch.device, dtype=torch.float32):
        self.device = device
        self.dtype = dtype
        self.lead = ()
        self.gen = None
        if device.type != "meta":
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(seed)

    def stacked(self, n: int) -> "Init":
        """The same stream, with every shape given a leading axis of n."""
        view = copy.copy(self)
        view.lead = (n,) + self.lead
        return view

    def normal(self, shape, std: float, dtype=None) -> torch.Tensor:
        """N(0, std^2) draws stored in ``dtype`` (the Init's by default)."""
        shape = self.lead + tuple(shape)
        dtype = dtype or self.dtype
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        if len(shape) > 1 and 4 * math.prod(shape) > DRAW_PIECE_BYTES:
            out = torch.empty(shape, dtype=dtype, device=self.device)
            for item in out:
                item.copy_(torch.randn(shape[1:], generator=self.gen, dtype=torch.float32,
                                       device=self.device).mul_(std))
            return out
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        # scaled in place: one f32 transient, not two (a stacked 4608 x 36864
        # gemma2 leaf is 15.6 GB in f32)
        return w.mul_(std).to(dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(self.lead + tuple(shape), dtype=torch.float32, device=self.device)

    def const(self, values: torch.Tensor) -> torch.Tensor:
        """A fixed f32 leaf (``values``, made on the host), the same in every
        stacked item; it draws nothing from the stream."""
        shape = self.lead + tuple(values.shape)
        if self.gen is None:
            return torch.empty(shape, dtype=torch.float32, device=self.device)
        return values.to(torch.float32).to(self.device).expand(shape).contiguous()

    def dense(self, d_in: int, d_out: int, *, bias: bool = False,
              scale: float | None = None) -> dict:
        p = {"w": self.normal((d_in, d_out), scale if scale is not None else d_in**-0.5)}
        if bias:
            p["b"] = self.zeros((d_out,))
        return p

    def norm(self, d: int, norm_type: str) -> dict:
        p = {"scale": self.zeros((d,))}
        if norm_type == "layernorm":
            p["bias"] = self.zeros((d,))
        return p


def dense(params: dict, x: torch.Tensor, *, mode: str = "dequant_einsum") -> torch.Tensor:
    return linear(x, params["w"], params.get("b"), mode=mode)
