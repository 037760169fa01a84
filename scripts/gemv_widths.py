#!/usr/bin/env python3
"""B1's tensor-core decode GEMV at every bit width, a Qwen2-7B step at a time.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/gemv_widths.py                        # this checkout's kernels
    python3 scripts/gemv_widths.py --csrc OTHER/src/repro_torch/csrc

For each width from 3 to 8 bits: one decode step's 197 GEMVs (Qwen2-7B's
wq, wk, wv, wo, w_gate, w_up, w_down in 28 layers and the lm_head) at M =
4 bf16 rows, on random packed words in the layout the model stores (rows of
ceil(K / cpw) words, the spare bits zero) and bf16 scales of block 64,
each matrix its own (3-7 GB a step, so no launch finds its words in the 50
MB L2).  Times are device times: the step's launches captured in a CUDA
graph, the median of 10 replays by CUDA events.  Beside each: the bytes
bound (words and scales at 3.35 TB/s), and with --library torch.matmul on
random bf16 weights of the same shapes (a time yardstick, not the same
values).  With --padded the rows are padded to whole uint4s of words (K
to lcm(cpw, 64), as kernels/qmatmul.pad_k pads them), the layout
that needs a copy of the weight at 3, 5 and 6 bits.  `--csrc` builds
qgemv_sm90.cu from another tree (say a parent
commit unpacked with git archive) with the port's nvcc flags; a width its
entry refuses is reported as such.  Prints one JSON object a width, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "gemv_widths"
M, BLOCK, REPS = 4, 64, 10
D, F, KV, V, LAYERS = 3584, 18944, 512, 152064, 28
# (K, N) of one decode step's launches
STEP = ([(D, D)] * 2 + [(D, KV)] * 2 + [(D, F)] * 2 + [(F, D)]) * LAYERS + [(D, V)]


def build(csrc: Path) -> ctypes.CDLL:
    """qgemv_sm90.cu of `csrc`, compiled as the port compiles it."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = csrc / "qgemv_sm90.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib_path = OUT / f"qgemv_sm90-{digest}.so"
    if not lib_path.is_file():
        OUT.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.qmatmul_gemv_tc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.qmatmul_gemv_tc.restype = ctypes.c_int
    return lib


def time_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=ROOT / "src" / "repro_torch" / "csrc")
    ap.add_argument("--padded", action="store_true",
                    help="rows padded to whole uint4s of words, not as stored")
    ap.add_argument("--library", action="store_true",
                    help="also time torch.matmul on bf16 weights of the step's shapes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemv_widths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.codebooks import make_codebook

    lib = build(args.csrc.resolve())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for bits in range(3, 9):
        cpw = 32 // bits
        cb = make_codebook("float", bits, device=dev)
        mats, nbytes = [], 0
        for K0, N in STEP:
            unit = cpw * BLOCK // math.gcd(cpw, BLOCK) if args.padded else BLOCK
            K = -(-K0 // unit) * unit
            words = torch.randint(-2**31, 2**31 - 1, (N, -(-K // cpw)), generator=g, device=dev,
                                  dtype=torch.int32)
            if cpw * bits < 32:
                words &= (1 << (cpw * bits)) - 1
            scales = (torch.rand((N, K // BLOCK), generator=g, device=dev) * 0.1).to(torch.bfloat16)
            mats.append((K, N, words, scales, torch.empty((M, N), dtype=torch.bfloat16, device=dev)))
            nbytes += words.numel() * 4 + scales.numel() * 2
        xs = {K: torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
              for K in {m[0] for m in mats}}

        def step():
            stream = torch.cuda.current_stream().cuda_stream   # the capture's, in a graph
            for K, N, words, scales, y in mats:
                status = lib.qmatmul_gemv_tc(xs[K].data_ptr(), words.data_ptr(), scales.data_ptr(),
                                             cb.data_ptr(), y.data_ptr(), M, N, K, words.shape[1],
                                             bits, BLOCK, stream)
                if status:
                    raise ValueError(status)

        row = {"bits": bits, "csrc": str(args.csrc), "rows": "padded" if args.padded else "stored",
               "bound_ms": nbytes / 3.35e12 * 1e3, "bytes": nbytes}
        try:
            row["ms"] = time_ms(torch, step)
        except ValueError:
            row["ms"] = None   # this build's entry does not take the width
        if args.library:
            dense = [torch.randn((N, K), generator=g, device=dev).to(torch.bfloat16)
                     for K, N, *_ in mats]
            row["torch_matmul_bf16_ms"] = time_ms(
                torch, lambda: [torch.matmul(xs[w.shape[1]], w.T) for w in dense])
            del dense
        print(json.dumps(row), flush=True)
        del mats, xs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
