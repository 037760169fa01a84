#!/usr/bin/env python3
"""The decode GEMV for f32 activations: this checkout's (``csrc/qmatmul.cu``
``qgemv``, TF32 on the tensor cores), the CUDA-core design beside it
(``scripts/gemv_f32_simt.cu``) and, with ``--csrc``, another tree's
``qmatmul.cu``, on the same operands.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/gemv_f32.py
    python3 scripts/gemv_f32.py --csrc OTHER/src/repro_torch/csrc
    python3 scripts/gemv_f32.py --knobs   # also this kernel's knob variants

Workloads (random packed words and bf16 scales, f32 x from a seeded
generator):

* ``qwen2_7b_step``: a Qwen2-7B decode step's 197 matrices (28 layers of
  wq, wk, wv, wo, w_gate, w_up, w_down, and the lm_head), 4-bit float,
  blocks of 64, each matrix its own weight (3.7 GB, so no launch finds its
  weight in the 50 MB L2), at M = 1, 4 and 8;
* ``kernel_bench``: ``paper/kernel_bench.py``'s shape (M, K, N = 8, 2048,
  2048) at int3, int4, float4 and int8, blocks of 64, rows as stored (205
  words a row at 3 bits).  A kernel that needs whole words (the first
  design's) gets rows padded beforehand, so its time holds no copy.

Each kernel is built from source with the port's nvcc flags into
build/gemv_f32/, checked against ``qmatmul_plain`` (relative error <= 2e-5
on each shape) and, for this checkout's kernel, a row at M = 1 against the
same row at M = 8 bit for bit.  Then each workload's launches are captured
in one CUDA graph and timed by CUDA events, the median of 10 replays, in
turns (kernels in order, then reversed).  Prints one JSON object a
workload and M with each kernel's times and the bound (bytes at 3.35 TB/s:
packed words, scales and codebook read once, f32 x in and y out; or the
f32 operations 2 M N K at the rate of the unit the kernel multiplies on:
495 / 3 TFLOP/s for 3xTF32, 67 TFLOP/s on the CUDA cores), then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "gemv_f32"
BLOCK, REPS = 64, 10
STEP_BITS, STEP_MS = 4, (1, 4, 8)
REL_TOL = 2e-5
HBM_BYTES_PER_S = 3.35e12
RATES = {"tf32x3": 495e12 / 3, "cuda_cores": 67e12}
# this kernel's knobs: (constant as written, values to try)
KNOBS = {"GV_TILES": ("constexpr int GV_TILES = 2;", (1,)),
         "GV_OCCUPANCY": ("constexpr int GV_OCCUPANCY = 24;", (16,)),
         "GV_LANE_WORDS": ("constexpr int GV_LANE_WORDS = 2;", (4,)),
         "GV_FILL_PER_SM": ("constexpr int GV_FILL_PER_SM = 32;", (64,))}
# and knob combinations, each one variant
KNOB_SETS = ({"GV_TILES": 1, "GV_LANE_WORDS": 4},)
MMA_ASM = (
    '  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
    '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n'
    '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
    '      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),\n'
    '        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));')
# where this kernel's time goes (--ablate, 4-bit float operands): each
# variant cuts one part by a text substitution and computes wrong results on
# purpose; a cut keeps its operands alive by an XOR fold into the output
ABLATIONS = {
    "no_mma": [(MMA_ASM, "\n".join(
        f"  d[{e}] = __uint_as_float(__float_as_uint(d[{e}]) ^ __float_as_uint(a[{e}])"
        f" ^ __float_as_uint({'b0' if e % 2 == 0 else 'b1'}));" for e in range(4)))],
    "no_scale_loads": [("    return b < n_blocks ? bf16_bits_to_float(__ldg(cols.s[r] + b)) : 0.f;",
                        "    return b < n_blocks ? 1.0f + r : 0.f;")],
    "no_x_loads": [("        load_run<T, C::RUN_CODES>(xrow + kc + u * C::GROUP_CODES, xv[u]);",
                    "        for (int j = 0; j < C::RUN_CODES; ++j) xv[u][j] = __int_as_float(kc + j);")],
    "no_word_loads": [("          const uint2 v = w < n_words ? __ldg(reinterpret_cast<const uint2*>(cols.w[r] + w))\n"
                       "                                      : make_uint2(0u, 0u);",
                       "          const uint2 v = make_uint2(w * 0x9E3779B9u + r, w ^ r);")],
    "no_decode": [("              ahi[r / 2][e] = lds_f32(tab_addr + run[u][r].offset(j));",
                   "              ahi[r / 2][e] = __uint_as_float(run[u][r].w[j / 8] << (j % 8));")],
}
GEMV_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
SIMT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def build(text: str, tag: str, entry: str, argtypes):
    """(tag, C function): a source text compiled as the port compiles it."""
    from repro_torch.kernels import _build

    digest = hashlib.sha256(text.encode() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:12]
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / f"{tag}-{digest}.so"
    if not lib_path.is_file():
        src = OUT / f"{tag}-{digest}.cu"
        src.write_text(text)
        done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                              capture_output=True, text=True)
        if done.returncode:
            raise SystemExit(f"{tag}: nvcc failed\n{done.stderr[-4000:]}")
        spills = [ln.strip() for ln in done.stderr.splitlines() if "spill" in ln
                  and not ln.strip().startswith("0 bytes spill")]
        print(json.dumps({"built": tag, "spill_lines": sorted(set(spills))[:8]}), flush=True)
    fn = getattr(ctypes.CDLL(str(lib_path)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return tag, fn


def sources(args):
    """[(tag, text, entry, argtypes, needs whole words)] to build."""
    this = (ROOT / "src" / "repro_torch" / "csrc" / "qmatmul.cu").read_text()
    jobs = [("this", this, "qmatmul_gemv", GEMV_ARGS, False),
            ("cuda_cores", (ROOT / "scripts" / "gemv_f32_simt.cu").read_text(), "qgemv_f32_simt",
             SIMT_ARGS, False)]
    if args.knobs:
        for name, (line, values) in KNOBS.items():
            if line not in this:
                raise SystemExit(f"gemv_f32: qmatmul.cu no longer holds {line!r}")
            for v in values:
                jobs.append((f"this_{name.lower()}_{v}",
                             this.replace(line, line.rsplit("=", 1)[0] + f"= {v};"),
                             "qmatmul_gemv", GEMV_ARGS, False))
        for knobs in KNOB_SETS:
            text = this
            for name, v in knobs.items():
                line = KNOBS[name][0]
                text = text.replace(line, line.rsplit("=", 1)[0] + f"= {v};")
            jobs.append(("this_" + "_".join(f"{k.lower()[3:]}_{v}" for k, v in knobs.items()),
                         text, "qmatmul_gemv", GEMV_ARGS, False))
    if args.ablate:
        for name, subs in ABLATIONS.items():
            text = this
            for a, b in subs:
                if a not in text:
                    raise SystemExit(f"gemv_f32: qmatmul.cu no longer holds {a[:60]!r}")
                text = text.replace(a, b)
            jobs.append((f"ablate_{name}", text, "qmatmul_gemv", GEMV_ARGS, False))
    if args.csrc:
        other = (args.csrc / "qmatmul.cu").read_text()
        # the first design took whole words a row only (K == n_words * cpw)
        whole = "K != n_words * (32 / bits)" in other
        jobs.append(("other", other, "qmatmul_gemv", GEMV_ARGS, whole))
    return jobs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="another tree's src/repro_torch/csrc")
    ap.add_argument("--knobs", action="store_true", help="also time this kernel's knob variants")
    ap.add_argument("--ablate", action="store_true",
                    help="also time this kernel with one part cut at a time (wrong results)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gemv_f32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.paper import kernel_bench as kb

    jobs = sources(args)
    with ThreadPoolExecutor(len(jobs)) as pool:
        fns = dict(pool.map(lambda j: build(j[1], j[0], j[2], j[3]), jobs))
    whole = {j[0]: j[4] for j in jobs}
    simt = {"cuda_cores"}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def weight(K, N, bits):
        n_words = -(-K // (32 // bits))
        packed = torch.randint(-2**31, 2**31 - 1, (N, n_words), generator=g, device=dev,
                               dtype=torch.int32)
        scales = (torch.rand((N, K // BLOCK), generator=g, device=dev) * 0.05).to(torch.bfloat16)
        return packed, scales

    def launcher(tag, x, packed, scales, cb, bits, y):
        M, K = x.shape
        N, n_words = packed.shape
        fn = fns[tag]
        if whole[tag]:   # padded once here, so the time holds no copy
            x, packed, scales = qk.pad_k(x, packed, scales, math.lcm(32 // bits, BLOCK),
                                         bits=bits, block_size=BLOCK)
            K, n_words = x.shape[1], packed.shape[1]
        tail = () if tag in simt else (0,)   # qmatmul_gemv's x_is_bf16
        keep = (x, packed, scales)

        def go():
            status = fn(keep[0].data_ptr(), keep[1].data_ptr(), keep[2].data_ptr(),
                        cb.data_ptr(), y.data_ptr(), M, N, K, n_words, bits, BLOCK, *tail,
                        torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"{tag}: cudaError_t {status}")
        return go

    def timed(calls):
        """{tag: [ms ...]} over launches [(x, packed, scales, cb, bits, y)]."""
        runs = {tag: [launcher(tag, *c) for c in calls] for tag in fns}
        order = list(fns) + list(reversed(list(fns)))
        times = {tag: [] for tag in fns}
        for tag in order:
            times[tag].append(cs._time_ms(torch, lambda r=runs[tag]: [go() for go in r], REPS))
        return times

    def check(tag, x, packed, scales, cb, bits, what):
        y = torch.empty((x.shape[0], packed.shape[0]), device=dev)
        launcher(tag, x, packed, scales, cb, bits, y)()
        ref = qk.qmatmul_plain(x, packed, scales, cb, bits=bits, block_size=BLOCK)
        torch.cuda.synchronize()
        rel = float((y - ref).abs().max() / ref.abs().max())
        cs.require(rel <= REL_TOL or tag.startswith("ablate_"),
                   f"{tag} {what}: relative error {rel} > {REL_TOL}")
        return rel, y

    def bounds(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return {unit: max(t_bytes, flops / rate * 1e3) for unit, rate in RATES.items()}

    cfg = get_arch("qwen2-7b")
    D, F, KD, V = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim, cfg.vocab_size
    layer = [(D, D), (D, KD), (D, KD), (D, D), (D, F), (D, F), (F, D)]
    shapes = layer * cfg.n_layers + [(D, V)]
    cb = make_codebook("float", STEP_BITS, device=dev)
    weights = [weight(K, N, STEP_BITS) for K, N in shapes]
    for M in STEP_MS:
        xs = {K: torch.randn((M, K), generator=g, device=dev) for K in (D, F)}
        ys = [torch.empty((M, N), device=dev) for _, N in shapes]
        errs = {}
        for tag in fns:
            for i, (K, N) in enumerate(dict.fromkeys(shapes)):
                j = shapes.index((K, N))
                rel, y = check(tag, xs[K], *weights[j], cb, STEP_BITS, f"{K}x{N} M={M}")
                errs[tag] = max(errs.get(tag, 0.0), rel)
                if tag == "this" and M > 1:   # row 0 alone equals row 0 among M
                    y1 = torch.empty((1, N), device=dev)
                    launcher(tag, xs[K][:1].contiguous(), *weights[j], cb, STEP_BITS, y1)()
                    torch.cuda.synchronize()
                    cs.require(torch.equal(y1[0], y[0]), f"this {K}x{N}: row 0 differs at M={M}")
        calls = [(xs[K], p, s, cb, STEP_BITS, y) for (K, N), (p, s), y in zip(shapes, weights, ys)]
        nbytes = sum(p.numel() * 4 + s.numel() * 2 + cb.numel() * 4 + M * (K + N) * 4
                     for (K, N), (p, s) in zip(shapes, weights))
        flops = sum(2.0 * M * K * N for K, N in shapes)
        per_shape = {}
        for K, N in dict.fromkeys(shapes):   # ms a call, over the step's calls of a shape
            sub = [c for c, kn in zip(calls, shapes) if kn == (K, N)]
            per_shape[f"{K}x{N}"] = {tag: min(v) / len(sub) for tag, v in timed(sub).items()}
        print(json.dumps({"workload": "qwen2_7b_step", "M": M, "launches": len(shapes),
                          "ms": timed(calls), "max_rel_err": errs, "bound_ms": bounds(nbytes, flops),
                          "bytes": nbytes, "per_shape_ms_a_call": per_shape}), flush=True)
        del calls, ys
    del weights
    torch.cuda.empty_cache()

    M, K, N = kb.M, kb.K, kb.N
    x = torch.randn((M, K), generator=g, device=dev)
    for bits, dtype in kb.TAGS:
        cbk = make_codebook(dtype, bits, device=dev)
        p, s = weight(K, N, bits)
        errs = {tag: check(tag, x, p, s, cbk, bits, f"{dtype}{bits}")[0] for tag in fns}
        y = torch.empty((M, N), device=dev)
        nbytes = p.numel() * 4 + s.numel() * 2 + cbk.numel() * 4 + M * (K + N) * 4
        print(json.dumps({"workload": "kernel_bench", "tag": f"{dtype}{bits}", "M": M, "K": K,
                          "N": N, "ms": timed([(x, p, s, cbk, bits, y)]), "max_rel_err": errs,
                          "bound_ms": bounds(nbytes, 2.0 * M * K * N)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
