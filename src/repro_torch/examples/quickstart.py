"""Quickstart: the paper's technique in 30 lines — port of the reference's
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Quantizes a weight matrix at several precisions and data types with
block-wise absmax quantization (Dettmers & Zettlemoyer 2023, Eq. 1), shows
the accuracy/bits trade-off, and runs the fused dequant-matmul (on the card
B1's CUDA kernel, on the CPU its plain version).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import dequantize_tensor, quantization_error, quantize_tensor
from repro_torch.core.bits import quantized_bits_per_param
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(dev)
    g.manual_seed(0)
    w = torch.randn((1024, 512), generator=g, device=dev) * 0.04   # a weight matrix
    x = torch.randn((4, 1024), generator=g, device=dev)            # activations

    rows = {}
    print(f"{'config':24s} {'bits/param':>10} {'rel err':>9} {'matmul err':>11}")
    for bits, dtype in [(8, "int"), (4, "float"), (4, "quantile"), (3, "int")]:
        for block in (64, 1024):
            qt = quantize_tensor(w, bits=bits, dtype=dtype, block_size=block)
            err = float(quantization_error(w, qt))
            bpp = quantized_bits_per_param(bits, block).ideal_bits_per_param
            y_ref = x @ w
            y_q = x @ dequantize_tensor(qt, out_dtype=torch.float32)
            merr = float(torch.linalg.norm(y_q - y_ref) / torch.linalg.norm(y_ref))
            rows[f"{dtype}{bits}-b{block}"] = (bpp, err, merr)
            print(f"{dtype}{bits}-b{block:<5d}{'':10s} {bpp:10.3f} {err:9.4f} {merr:11.4f}")

    # the fused kernel path: B1's CUDA kernel on the card, its plain version
    # on the CPU
    op = ops.prepare_operand(w, bits=4, dtype="float", block_size=64)
    y_kernel = ops.qmatmul(x, op)
    y_dense = x @ w
    rel = float(torch.linalg.norm(y_kernel - y_dense) / torch.linalg.norm(y_dense))
    streamed = op.packed.numel() * 4 + op.scales.numel() * op.scales.element_size()
    print(f"\nfused 4-bit dequant-matmul kernel vs dense: rel err {rel:.4f}")
    print(f"weight bytes streamed: {streamed} vs bf16 {w.numel() * 2} "
          f"({streamed / (w.numel() * 2):.2f}x)")
    return {"rows": rows, "fused_rel_err": rel}


if __name__ == "__main__":
    main()
