"""Exact k-bit code packing into 32-bit words — port of ``repro/core/packing.py``.

``cpw = floor(32/k)`` codes per word, low bits first, with ``32 mod k`` bits
left unused for k in {3, 5, 6, 7}.  The reference stores uint32 words; the
port holds the same bits in an **int32** view, because PyTorch on the CPU
has no shifts for uint32.  On the int32 view ``(w >> s) & mask`` is exact:
the mask drops the bits that the arithmetic shift fills with the sign.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def codes_per_word(bits: int) -> int:
    return 32 // bits


def packed_size(n: int, bits: int) -> int:
    cpw = codes_per_word(bits)
    return (n + cpw - 1) // cpw


def to_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the same bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack k-bit codes along the last dim into int32 words (uint32 bits)."""
    cpw = codes_per_word(bits)
    n = codes.shape[-1]
    n_words = packed_size(n, bits)
    c = codes.to(torch.int64)
    pad = n_words * cpw - n
    if pad:
        c = F.pad(c, (0, pad))
    c = c.reshape(c.shape[:-1] + (n_words, cpw))
    shifts = torch.arange(cpw, dtype=torch.int64, device=c.device) * bits
    # codes occupy disjoint bit ranges, so a sum equals the bitwise OR
    return to_int32_words((c << shifts).sum(-1))


def unpack(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Unpack int32 words back to n k-bit codes (uint8) along the last dim."""
    cpw = codes_per_word(bits)
    shifts = torch.arange(cpw, dtype=torch.int32, device=words.device) * bits
    c = (words.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    c = c.reshape(words.shape[:-1] + (words.shape[-1] * cpw,))
    return c[..., :n].to(torch.uint8)


def stored_bits_per_param(bits: int) -> float:
    """Actual storage cost of one code given the word-aligned packing."""
    return 32.0 / codes_per_word(bits)
