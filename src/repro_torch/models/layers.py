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
"""

from __future__ import annotations

import copy

import torch

from repro_torch.core.qtensor import QuantizedTensor, dequantize_tensor
from repro_torch.kernels import ops


def resolve_matmul_mode(mode: str, w) -> str:
    """Per-matrix dispatch decision: 'fused' or 'dequant_einsum'."""
    if mode == "dequant_einsum":
        return "dequant_einsum"
    if mode not in ("auto", "fused"):
        raise ValueError(f"unknown matmul_mode {mode!r}")
    return "fused" if ops.qt_fused_eligible(w) else "dequant_einsum"


def matmul_rounded(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ wt[N, K]^T summed in f32, rounded to x's dtype."""
    return (x.to(torch.float32) @ wt.to(x.dtype).to(torch.float32).T).to(x.dtype)


def linear(x: torch.Tensor, w, bias=None, *, mode: str = "dequant_einsum") -> torch.Tensor:
    """y = x @ w (+ bias).  ``w`` is [in, out], or a QuantizedTensor storing
    the weight as (out, in) with blocks along the reduction dim."""
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


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    """jax.nn's formulas, one op at a time in x's dtype — each op rounds,
    as XLA evaluates them (a fused F.silu rounds once and differs in the
    last bf16 bit for about a third of the values)."""
    if act == "gelu":
        return 0.5 * x * (1 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))
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

    def normal(self, shape, std: float) -> torch.Tensor:
        shape = self.lead + tuple(shape)
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return (w * std).to(self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(self.lead + tuple(shape), dtype=torch.float32, device=self.device)

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
