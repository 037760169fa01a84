#!/usr/bin/env python3
"""Where B1's time goes: time a kernel with one part of its main loop
removed at a time, at Qwen2-7B's shapes.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/qgemm_ablate.py          # prefill GEMM, csrc/qgemm_sm90.cu
    python3 scripts/qgemm_ablate.py --gemv   # decode GEMVs, csrc/qgemv_sm90.cu
                                             # and qmatmul.cu's CUDA-core qgemv

Each variant is the kernel's source with one text substitution (the tables
below), built with the port's nvcc flags into build/ablate/.  A variant
computes wrong results on purpose (its max relative error is printed); only
its time means something.  Where a cut would leave values unused, an empty
`asm volatile` takes them as inputs, so the compiler keeps the rest of the
loop and emits no instruction for the cut.  Weights are 4-bit float, block
64; times are device times, a CUDA graph's replays timed by CUDA events (20
replays).  Prefill: one launch at M = 1024 per graph, weighted by each
shape's launches in one Qwen2-7B prefill (28 layers).  Decode: M = 4,
random packed words and scales in as many copies of each shape as its
launches a step or ~300 MB (so that no launch finds its weight in the 50 MB
L2), one launch per copy in a graph, weighted by each shape's launches in
one decode step.  Prints one JSON object per variant and
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ablate"
BITS, BLOCK, REPS = 4, 64, 20
M_PREFILL, M_DECODE = 1024, 4
# (K, N): launches in one prefill of Qwen2-7B (wq/wo, wk/wv, gate/up, down)
SHAPES = {(3584, 512): 56, (3584, 3584): 56, (3584, 18944): 56, (18944, 3584): 28}
# and in one decode step, with the lm_head
DECODE_SHAPES = {**SHAPES, (3584, 152064): 1}
COPY_BYTES = 300_000_000
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
TC_KEEP = [("  float d[4] = {};", "  float d[4] = {};\n  uint32_t keep = 0u;"),
           ("  for (int e = 0; e < 4; ++e) part[warp][lane][e] = d[e];",
            "  for (int e = 0; e < 4; ++e) part[warp][lane][e] = d[e] + __uint_as_float(keep & 1u);")]
# the tensor-core GEMV (qgemv_sm90.cu)
GEMV_TC_ABLATIONS = {
    "kernel": [],
    # the packed words themselves are the A fragments: no table read, scale
    # product or conversion (and so no scale loads)
    "no_decode": [("      for (int i = 0; i < ROWS; ++i) decode_word<BITS>(words[i][q], sc[i][q], lut_addr, pr[i]);",
                   "      for (int i = 0; i < ROWS; ++i)\n"
                   "        for (int p = 0; p < CPW / 2; ++p) pr[i][p] = words[i][q] >> p;")],
    # the fragments are folded by XOR into a register that reaches the
    # output, instead of multiplied (2 LOP3 for each mma)
    "no_mma": TC_KEEP + [
        ("        mma_16816(d, a, xv[q][2 * st], xv[q][2 * st + 1]);",
         "        keep ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ xv[q][2 * st] ^ xv[q][2 * st + 1];")],
    # B fragments from a constant
    "no_x_loads": [("    load_x<CPW, VEC>(xrow, has_x, w0, n_words, xv);",
                    "    for (int q = 0; q < WPL; ++q)\n"
                    "      for (int p = 0; p < CPW / 2; ++p) xv[q][p] = 0x3f803f80u;")],
    # words made in registers from their index
    "no_word_loads": [("    load_words<VEC>(r, w0, words);",
                       "    for (int i = 0; i < ROWS; ++i)\n"
                       "      for (int q = 0; q < WPL; ++q) words[i][q] = (w0 + q) * 0x9E3779B9u + i;")],
}
# the tensor-core GEMV's knobs (warps a block, the warps an SM must hold),
# each variant one text substitution of the defaults; and the table read
# through a generic pointer (an address add a code more)
GEMV_TC_KNOBS = {"min_warps": "constexpr int MIN_WARPS = 4;",
                 "max_warps": "constexpr int MAX_WARPS = 16;",
                 "occupancy": "constexpr int OCCUPANCY = 40;"}
GEMV_TC_CONFIGS = {"occ0": {"occupancy": 0}, "w8": {"min_warps": 8, "max_warps": 8}}
GEMV_TC_VARIANTS = {
    "lut_generic": [('  asm("ld.shared.f32 %0, [%1];\\n" : "=f"(v) : "r"(addr));',
                     "  v = *static_cast<const float*>(__cvta_shared_to_generic(addr));")],
}


def knob_subs(cfg):
    return [(GEMV_TC_KNOBS[k], GEMV_TC_KNOBS[k].rsplit("=", 1)[0] + f"= {v};")
            for k, v in cfg.items()]


# the CUDA-core GEMV (qmatmul.cu's qgemv_kernel), the same four cuts
SIMT_FMA = "          for (int r = 0; r < MR; ++r) acc[c][r] = fmaf(xv[r][j], wv, acc[c][r]);"
GEMV_SIMT_ABLATIONS = {
    "kernel": [],
    "no_decode": [("          const float wv = Act<T>::round(lut[(words[u][c] >> (j * BITS)) & MASK] * s[c]);",
                   "          const float wv = __uint_as_float(words[u][c] >> j);")],
    # the FMAs' operands folded by XOR into a register that reaches the
    # output: one fold a decoded value and one an activation, a quarter of
    # the FMAs' count at 4 rows and 4 columns
    "no_products": [
        ("  float acc[GV_COLS][MR];", "  float acc[GV_COLS][MR];\n  unsigned keep = 0u;"),
        ("  // every lane holds its warp's sums;",
         "  acc[0][0] += __uint_as_float(keep & 1u);\n  // every lane holds its warp's sums;"),
        ("        ++rem;\n#pragma unroll\n        for (int c = 0; c < GV_COLS; ++c) {",
         "        ++rem;\n        for (int r = 0; r < MR; ++r) keep ^= __float_as_uint(xv[r][j]);\n"
         "#pragma unroll\n        for (int c = 0; c < GV_COLS; ++c) {"),
        (SIMT_FMA, "          keep ^= __float_as_uint(wv);")],
    "no_x_loads": [("          load_run<T, CPW>(x + static_cast<size_t>(r) * K + k0, xv[r]);",
                    "          for (int j = 0; j < CPW; ++j) xv[r][j] = __int_as_float(k0 + j);")],
    "no_word_loads": [("      for (int c = 0; c < GV_COLS; ++c) words[u][c] = w < n_words ? __ldg(wrow[c] + w) : 0u;",
                       "      for (int c = 0; c < GV_COLS; ++c) words[u][c] = w * 0x9E3779B9u + c;")],
}
ARGTYPES = {
    "qgemm_sm90": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "qmatmul_gemv_tc": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "qmatmul_gemv": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}


def build(source, entry, name, subs):
    text = (CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {source} no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    from repro_torch.kernels import _build

    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{done.stderr[-4000:]}")
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return name, fn


def build_all(jobs):
    """{name: C function} for jobs [(source, entry, name, subs)], one nvcc each,
    all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(lambda job: build(*job), jobs))


def graph_ms(torch, fn, reps):
    """Device time of one call of fn: captured once in a CUDA graph, the
    mean of reps replays by CUDA events (no host launch overhead)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def rel_err(torch, y, ref):
    return float(((y.float() - ref).abs().max() / ref.abs().max()).nan_to_num(1e30))


def prefill(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk

    M = M_PREFILL
    libs = build_all([("qgemm_sm90.cu", "qgemm_sm90", name, subs)
                      for name, subs in ABLATIONS.items()])
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
        for name, fn in libs.items():
            def launch():
                status = fn(
                    xp.data_ptr(), packed.data_ptr(), scales.data_ptr(), op.codebook.data_ptr(),
                    y.data_ptr(), xt.data_ptr(), ws.data_ptr() if ws is not None else None,
                    M, N, xp.shape[1], packed.shape[1], BITS, BLOCK, split,
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"{name}: cudaError_t {status}")
            launch()
            torch.cuda.synchronize()
            err = rel_err(torch, y, ref)
            result[name]["us_per_call"][f"{K}x{N}"] = graph_ms(torch, launch, REPS) * 1e3
            result[name]["max_rel_err"] = max(result[name]["max_rel_err"], err)
    for name, r in result.items():
        r["prefill_ms"] = sum(r["us_per_call"][f"{K}x{N}"] * n
                              for (K, N), n in SHAPES.items()) / 1e3
        print(json.dumps({"variant": name, **r}), flush=True)


def decode(torch, dev):
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import qmatmul as qk

    M = M_DECODE
    jobs = [("qgemv_sm90.cu", "qmatmul_gemv_tc", f"gemv_tc_{n}", s)
            for n, s in GEMV_TC_ABLATIONS.items()]
    jobs += [("qgemv_sm90.cu", "qmatmul_gemv_tc", f"gemv_tc_cfg_{n}", knob_subs(c))
             for n, c in GEMV_TC_CONFIGS.items()]
    jobs += [("qgemv_sm90.cu", "qmatmul_gemv_tc", f"gemv_tc_cfg_{n}", s)
             for n, s in GEMV_TC_VARIANTS.items()]
    jobs += [("qmatmul.cu", "qmatmul_gemv", f"gemv_simt_{n}", s)
             for n, s in GEMV_SIMT_ABLATIONS.items()]
    libs = build_all(jobs)
    g = torch.Generator(device=dev).manual_seed(0)
    cb = make_codebook("float", BITS, device=dev)
    result = {name: {"us_per_call": {}, "max_rel_err": 0.0} for name in libs}
    for (K, N), per_step in DECODE_SHAPES.items():
        n_words = K * BITS // 32
        copies = max(1, min(per_step, -(-COPY_BYTES // (N * n_words * 4))))
        weights = [(torch.randint(-2**31, 2**31 - 1, (N, n_words), generator=g, device=dev,
                                  dtype=torch.int32),
                    (torch.rand((N, K // BLOCK), generator=g, device=dev) * 0.05)
                    .to(torch.bfloat16)) for _ in range(copies)]
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        ref = qk.qmatmul_plain(x, *weights[0], cb, bits=BITS, block_size=BLOCK).float()
        y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        for name, fn in libs.items():
            tail = (1,) if "simt" in name else ()   # qmatmul_gemv's x_is_bf16

            def launch(packed, scales, fn=fn, tail=tail, name=name):
                status = fn(x.data_ptr(), packed.data_ptr(), scales.data_ptr(), cb.data_ptr(),
                            y.data_ptr(), M, N, K, n_words, BITS, BLOCK, *tail,
                            torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"{name}: cudaError_t {status}")

            launch(*weights[0])
            torch.cuda.synchronize()
            err = rel_err(torch, y, ref)

            def rounds():
                for packed, scales in weights:
                    launch(packed, scales)
            us = graph_ms(torch, rounds, REPS) / copies * 1e3
            result[name]["us_per_call"][f"{K}x{N}"] = us
            result[name]["max_rel_err"] = max(result[name]["max_rel_err"], err)
        del weights
        torch.cuda.empty_cache()
    for name, r in result.items():
        r["decode_step_ms"] = sum(r["us_per_call"][f"{K}x{N}"] * n
                                  for (K, N), n in DECODE_SHAPES.items()) / 1e3
        print(json.dumps({"variant": name, **r}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qgemm_ablate: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    (decode if "--gemv" in sys.argv[1:] else prefill)(torch, dev)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
