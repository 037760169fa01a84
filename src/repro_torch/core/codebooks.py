"""Quantization data types ("codebooks") from Dettmers & Zettlemoyer 2023,
App. A — port of ``repro/core/codebooks.py``.

A k-bit data type is its sorted codebook: the 2**k values in [-1, 1] that
the k-bit codes map to.  The int, float and dynamic tables are built in
numpy exactly as the reference builds them (so they are equal in float32);
``make_codebook`` hands them out as torch tensors.  The quantile codebook
is data dependent and computed with torch on the tensor's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.utils import cost

DATA_TYPES = ("int", "float", "dynamic", "quantile")

#: paper App. A: 3-bit exponent for 4..8-bit float, 2-bit for 3-bit float.
PAPER_EXPONENT_BITS = {3: 2, 4: 3, 5: 3, 6: 3, 7: 3, 8: 3}


def _normalize(values) -> np.ndarray:
    """Normalize a codebook to absmax 1 and return it sorted, float32."""
    values = np.asarray(values, dtype=np.float64)
    m = np.max(np.abs(values))
    if m > 0:
        values = values / m
    return np.sort(values).astype(np.float32)


@functools.lru_cache(maxsize=None)
def int_codebook(bits: int) -> np.ndarray:
    """Symmetric linear quantization, truncated to +/-(2^(k-1)-1) (paper §A);
    with 2^k codes one extreme value appears twice."""
    half = 2 ** (bits - 1) - 1
    codes = np.arange(2**bits) - half
    codes = np.clip(codes, -half, half)
    return _normalize(codes / max(half, 1))


@functools.lru_cache(maxsize=None)
def float_codebook(bits: int, exponent_bits: int | None = None) -> np.ndarray:
    """ExMy minifloat codebook, bias = 2^(E-1)+1, subnormals, no NaN/Inf."""
    if exponent_bits is None:
        exponent_bits = PAPER_EXPONENT_BITS[bits]
    E = exponent_bits
    M = bits - 1 - E
    if M < 0:
        raise ValueError(f"float{bits} needs >= {E + 1} bits for E={E}")
    bias = 2 ** (E - 1) + 1
    values = []
    for sign in (0, 1):
        s = -1.0 if sign else 1.0
        for e in range(2**E):
            for m in range(2**M):
                frac = m / (2**M)
                if e == 0:  # subnormal
                    v = s * 2.0 ** (1 - bias) * frac
                else:
                    v = s * 2.0 ** (e - bias) * (1.0 + frac)
                values.append(v)
    return _normalize(values)


@functools.lru_cache(maxsize=None)
def dynamic_codebook(bits: int) -> np.ndarray:
    """Dynamic exponent data type (Dettmers 2016): sign, base-10 zero-run
    exponent, indicator bit, linear fraction over [0.1, 0.9]; padded to 2^k
    entries by repeating the max (a duplicate never wins searchsorted)."""
    values = [0.0]
    for sign in (1.0, -1.0):
        for z in range(bits - 1):
            w = bits - 2 - z
            n = 2**w
            fracs = 0.1 + (0.8 * (np.arange(n) + 0.5) / n)
            for f in fracs:
                values.append(sign * (10.0**-z) * f)
    values = np.unique(np.asarray(values))
    while values.size < 2**bits:
        values = np.append(values, values.max())
    return _normalize(values)


def quantile_codebook(tensor: torch.Tensor, bits: int,
                      num_samples: int = 16384) -> torch.Tensor:
    """Equal-occupancy codebook from the empirical CDF (paper Eq. 6) with an
    explicit 0, estimated on a strided subsample; f32 on the tensor's device."""
    flat = tensor.reshape(-1).to(torch.float32)
    if flat.numel() > num_samples:
        stride = flat.numel() // num_samples
        flat = flat[::stride][:num_samples]
    n = 2**bits
    probs = torch.arange(1, n + 1, dtype=torch.float32, device=flat.device) / (n + 1)
    qs = torch.quantile(flat, probs)
    mids = (qs[:-1] + qs[1:]) / 2.0
    cb = torch.cat([mids, torch.zeros(1, dtype=torch.float32, device=flat.device)])
    cb = cb / torch.clamp(cb.abs().max(), min=1e-12)
    return torch.sort(cb).values


@functools.lru_cache(maxsize=None)
def _static_codebook(dtype: str, bits: int, exponent_bits, device: str,
                     fake_mode=None) -> torch.Tensor:
    """One shared tensor per (type, bits, device): callers must not write
    to it.  Saves a host-to-device copy on every KV-cache read.  Under a
    fake mode (the dry-run's) one of that mode's own, as a fake tensor
    serves its mode alone."""
    table = {"int": lambda: int_codebook(bits),
             "float": lambda: float_codebook(bits, exponent_bits),
             "dynamic": lambda: dynamic_codebook(bits)}[dtype]()
    return torch.from_numpy(table.copy()).to(device)


def make_codebook(dtype: str, bits: int, *, exponent_bits: int | None = None,
                  tensor: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """The sorted f32 codebook of a data type.  ``tensor`` is required for
    quantile (and sets the device); static tables go to ``device``, or to
    the tensor's device when only a tensor is given."""
    if device is None:
        if tensor is None:
            raise ValueError("make_codebook needs device= (or tensor=)")
        device = tensor.device
    if dtype in ("int", "float", "dynamic"):
        return _static_codebook(dtype, bits, exponent_bits, str(torch.device(device)),
                                cost.fake_mode())
    if dtype == "quantile":
        if tensor is None:
            raise ValueError("quantile codebook is data-dependent; pass tensor=")
        return quantile_codebook(tensor.to(device), bits)
    raise ValueError(f"unknown quantization data type {dtype!r}; want {DATA_TYPES}")


def codebook_boundaries(codebook: torch.Tensor) -> torch.Tensor:
    """Decision boundaries (midpoints) for nearest-value encode via searchsorted."""
    return (codebook[:-1] + codebook[1:]) / 2.0
