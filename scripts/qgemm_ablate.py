#!/usr/bin/env python3
"""Where the prefill GEMM's time goes: time csrc/qgemm_sm90.cu with one part
of its main loop removed at a time, at Qwen2-7B's prefill shapes.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/qgemm_ablate.py

Each variant is the kernel's source with one text substitution (ABLATIONS
below), built with the port's nvcc flags into build/ablate/.  A variant
computes wrong results on purpose (its max relative error is printed); only
its time means something.  Times are CUDA-event means over 20 launches at
M = 1024, 4-bit float weights, block 64; "prefill" weights each shape by its
launches in one Qwen2-7B prefill (28 layers).  Prints one JSON object per
variant and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "qgemm_sm90.cu"
OUT = ROOT / "build" / "ablate"
M, BITS, BLOCK, REPS = 1024, 4, 64, 20
# (K, N): launches in one prefill of Qwen2-7B (wq/wo, wk/wv, gate/up, down)
SHAPES = {(3584, 512): 56, (3584, 3584): 56, (3584, 18944): 56, (18944, 3584): 28}
DECODE = ("      tile.decode(t0 + it + 1, s1, (it + 1) % WS_SLOTS, lut, cur, [&](int r) {\n"
          "        tile.mma(s, w, wg, acc, r * C::MMAS / C::GROUPS, (r + 1) * C::MMAS / C::GROUPS);\n"
          "      });")
ABLATIONS = {
    "kernel": [],
    # the consumers issue the products but decode nothing
    "no_decode": [(DECODE, "      tile.mma(s, w, wg, acc, 0, C::MMAS);")],
    # the consumers decode but issue no products
    "no_products": [(DECODE, DECODE.replace("        tile.mma(", "        if (false) tile.mma(")),
                    ("      tile.mma(s, w, wg, acc, 0, C::MMAS);",
                     "      if (false) tile.mma(s, w, wg, acc, 0, C::MMAS);")],
    # the producer copies no x tile (the products read a stale one)
    "no_x_copy": [("      bulk_copy(smem_u32(st), p.x_tiles + tile * C::X_BYTES, C::X_BYTES, bar);",
                   "      mbar_arrive(bar);")],
    # the producer copies no packed words (the decode reads stale ones)
    "no_word_copy": [("        cp_async16(ps + i * 16,", "        if (false) cp_async16(ps + i * 16,")],
}


def build(name, subs):
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: the kernel source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    from repro_torch.kernels import _build

    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{done.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    lib.qgemm_sm90.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.qgemm_sm90.restype = ctypes.c_int
    return name, lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qgemm_ablate: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        libs = dict(pool.map(lambda kv: build(*kv), ABLATIONS.items()))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {name: {"us_per_call": {}, "max_rel_err": 0.0} for name in libs}
    for (K, N), _ in SHAPES.items():
        w = torch.randn((K, N), generator=g, device=dev) * 0.05
        op = ops.prepare_operand(w, bits=BITS, dtype="float", block_size=BLOCK)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        xp, packed, scales = ops.pad_for_kernel(x, op)
        ref = qk.qmatmul_plain(xp, packed, scales, op.codebook, bits=BITS,
                               block_size=BLOCK).float()
        split = qk.split_k(M, N, xp.shape[1], BITS, sms)
        shape = qk.split_workspace_shape(M, N, split)
        ws = torch.empty(shape, dtype=torch.float32, device=dev) if shape else None
        xt = torch.empty(qk.x_tiles_shape(M, xp.shape[1], BITS), dtype=torch.bfloat16,
                         device=dev)
        y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        for name, lib in libs.items():
            def launch():
                status = lib.qgemm_sm90(
                    xp.data_ptr(), packed.data_ptr(), scales.data_ptr(), op.codebook.data_ptr(),
                    y.data_ptr(), xt.data_ptr(), ws.data_ptr() if ws is not None else None,
                    M, N, xp.shape[1], packed.shape[1], BITS, BLOCK, split,
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"{name}: cudaError_t {status}")
            launch()
            torch.cuda.synchronize()
            err = float(((y.float() - ref).abs().max() / ref.abs().max()).nan_to_num(1e30))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                launch()
            end.record()
            end.synchronize()
            result[name]["us_per_call"][f"{K}x{N}"] = start.elapsed_time(end) / REPS * 1e3
            result[name]["max_rel_err"] = max(result[name]["max_rel_err"], err)
    for name, r in result.items():
        r["prefill_ms"] = sum(r["us_per_call"][f"{K}x{N}"] * n
                              for (K, N), n in SHAPES.items()) / 1e3
        print(json.dumps({"variant": name, **r}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
