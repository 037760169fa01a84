#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:
  1. build   — compile every CUDA source of the port (one nvcc each, in
               parallel) into build/kernels/.
  2. kernels — hold each kernel against its plain PyTorch version on the card:
               the fused dequant-GEMM (f32 activations: relative error
               <= 2e-5, f32 summation order; bf16: <= 2^-7 * max|y|, one
               bf16 ulp at the max) at Qwen2-7B's shapes, both GEMVs' and
               the tensor-core GEMM's edges (3 to 8 bits) and split-K
               shapes and the paper sweep's shapes, the KV dequant
               (bit-exact), the blockwise encode (bit-exact codes and
               scale bits), the encode to the stored form (bit-exact words
               and scale bits) and the fused decode attention over the
               packed cache (<= 2^-6 * max|out| per row and head).
  3. serve   — Qwen2-7B at full width and depth, seeded random weights
               quantized on the card (4-bit float, block 64; one
               quantize_pack launch per quantized matrix), Engine with a
               kv4 cache: 4 prompts x 256 tokens, 32 greedy tokens.  Checks
               finite logits and the kernel launches per decode step (every
               GEMV on the tensor cores, qgemv_sm90; one fused attention a
               layer and no standalone KV dequant).
  4. modes   — teacher-forced logits, fused kernel vs dequant_einsum.
  5. kv_tol  — kv_oracle_logit_gap on tiny-650k, kernels in the loop.
  6. paper   — the paper's bit-level sweep: trains the tiny ladder on the
               card (paper.common.TRAIN_RECIPE), encodes every checkpoint
               through the encode kernels and reads perplexity through the
               fused GEMM (fig2: k in {3,4,5,6,8,16}; fig3 data types and
               block sizes); gates training progress and 8-bit perplexity.
  7. times   — each kernel at the main path's shapes beside its plain
               version, its bound and a PyTorch library call, each timed
               as device time: captured in a CUDA graph and replayed; B1
               also per shape, beside torch.matmul per shape, and the
               decode GEMV beside the CUDA-core GEMV on the same operands;
               the encode beside the chain it replaced, the fused attention
               beside the path it replaced at 288 and 4096 slots.
Then the kernels line, the card's name and power limit, and the result.
Needs no network, imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "qwen2-7b"
BATCH, PROMPT, NEW_TOKENS, KV_BITS = 4, 256, 32, 4
# H100 SXM data-sheet rates: HBM bytes/s, dense bf16 tensor-core FLOP/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
F32_REL_TOL = 2e-5          # tests/test_qmatmul_parity.py REL_TOL: f32 summation order
BF16_REL_TOL = 2.0 ** -7    # one bf16 ulp at max|y|
# the fused decode attention against its plain version, per (batch row,
# head): two bf16 ulps at the row's max; only f32 summation order differs,
# which can flip the bf16 rounding of a p or of the output
ATT_REL_TOL = 2.0 ** -6
LONG_CONTEXT = 4096          # the fused attention's second timing point
ONE_TILE = 16                # its fixed cost: one 16-slot tile, on one CTA of a cluster
# a logit soft-cap that bends the random scores of check_attention (about
# N(0, 1)); gemma2's 50 would leave them nearly straight
SOFTCAP = 5.0
MULTI_ROUND = 16384          # slots past one shared-memory round of the fused attention
# fused vs dequant_einsum multiply the same bf16-rounded weights and differ
# only in the order (and, on the tensor cores, the grouping) of their f32
# sums.  That flips single bf16 roundings of activations, which carry through
# 28 layers of random weights into ~155M logits of size ~6, where a bf16 ulp
# is 0.03.  Such a gap stays a few ulps; a gap near KV_LOGIT_TOL[4] = 1.0
# would mean the two paths multiply different weights.  The gate is half of
# that tolerance.
MODE_GAP_TOL = 0.5
# the paper finds 8-bit weights indistinguishable from 16-bit (the
# reference's own ladder, trained on the CPU, sits within 0.11 % of it), so a
# model whose 8-bit perplexity is more than 1 % off its 16-bit one has a
# broken encode or GEMM
PPL_K8_REL_TOL = 0.01
# training must have learnt: the last loss at least this many nats below the first
MIN_LOSS_DROP = 1.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from the repository root",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build(["qgemv_sm90", "qmatmul", "qgemm_sm90", "kv_dequant", "quantize",
                           "quantize_pack", "kv_decode_attention"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in report.items()}})

    errs = check_kernels(torch, dev)
    run = serve_main_path(torch, dev)
    mode_parity(torch, dev, run)
    kv_tolerance(torch, dev)
    paper = paper_path(torch, dev)
    times = time_kernels(torch, dev, run)
    del run

    kernels = []
    swept = dict(paper["launches"])
    swept["gemm"] -= swept["gemm_simt"]   # the tensor-core GEMM's share
    for name, key, count in (("qmatmul_gemv", "gemv", "gemv_tc"),
                             ("qmatmul_gemv_simt", "gemv_simt", "gemv_simt"),
                             ("qmatmul_gemm", "gemm", "gemm"),
                             ("qgemm_simt", "gemm_simt", "gemm_simt"),
                             ("kv_dequant", "kv", "kv"), ("kv_decode_attention", "attn", "attn"),
                             ("quantize_blocks", "b3", "b3"), ("quantize_pack", "pack", "pack")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": t["source"], "replaces": t["replaces"],
            # the main paths' launches: serving Qwen2-7B (its quantization
            # included) and the paper's sweep
            "launches": t["launches"] + swept[count],
            "max_abs_err": errs[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"kernels": kernels})
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _gen(torch, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def check_kernels(torch, dev) -> dict:
    """Phase 2: every kernel against its plain version on the same inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels import quantize as quantk

    g = _gen(torch, dev, SEED + 1)
    worst = {"gemv": 0.0, "gemv_simt": 0.0, "gemm": 0.0, "gemm_simt": 0.0, "kv": 0.0,
             "attn": 0.0, "b3": 0.0, "pack": 0.0}
    n_checks = 0

    def check_b1(Ms, K, N, bits, dtype, block, xdt, main_path, launch=None):
        """One weight, x of each row count in Ms: `launch` (default the
        kernel qmatmul_cuda picks) against the plain version."""
        nonlocal n_checks
        w = torch.randn((K, N), generator=g, device=dev) * 0.05
        op = ops.prepare_operand(w, bits=bits, dtype=dtype, block_size=block)
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=dev).to(xdt)
            xp, packed, scales = ops.pad_for_kernel(x, op)
            kw = dict(bits=bits, block_size=block)
            y_k = (launch or qk.qmatmul_cuda)(xp, packed, scales, op.codebook, **kw).float()
            y_p = qk.qmatmul_plain(xp, packed, scales, op.codebook, **kw).float()
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            ref = float(y_p.abs().max())
            tol = (F32_REL_TOL if xdt == torch.float32 else BF16_REL_TOL) * ref
            require(bool(torch.isfinite(y_k).all()) and err <= tol,
                    f"qmatmul M={M} K={K} N={N} bits={bits} {dtype} b{block} {xdt}: "
                    f"max|err| {err} > {tol}")
            if main_path:
                key = "gemv" if xp.shape[0] <= qk.GEMV_MAX_M else "gemm"
                worst[key] = max(worst[key], err)
            elif launch is None:   # the CUDA-core routes, off the main paths
                if M <= qk.GEMV_MAX_M and qk.gemv_route(xdt, bits, block) == "simt":
                    worst["gemv_simt"] = max(worst["gemv_simt"], err)
                elif M > qk.GEMV_MAX_M and xdt == torch.float32:
                    worst["gemm_simt"] = max(worst["gemm_simt"], err)
            n_checks += 1

    # odd word tails and scale blocks that words straddle; the GEMVs at 1, 2,
    # 4 and 8 rows (3 and 5 mask rows), the tiled kernels past 8 rows
    for bits in (3, 4, 5, 6, 7, 8):
        for dtype in ("int", "float", "dynamic"):
            for xdt in (torch.float32, torch.bfloat16):
                for block in (16, 32):
                    check_b1((1, 2, 3, 5, 37), 200, 70, bits, dtype, block, xdt, False)
    # the tensor-core GEMV's edges: every row count it instantiates nothing
    # for (it always multiplies 8), column tails around its 16-column
    # blocks, K tails off its 128-code chunks (n_words % 16 != 0), at 4, 7
    # and 8 bits over three data types and blocks; then rows of words not a
    # multiple of 4, which it reads a word at a time, and scale blocks of a
    # word count that is not a power of two
    before_tc = qk.qmatmul_gemv_tc.launches
    for bits in qk.TC_GEMV_BITS:
        for dtype in ("int", "float", "dynamic"):
            for block in (16, 32, 64):
                for i, N in enumerate((8, 16, 17, 70, 512)):
                    check_b1((1, 2, 3, 4, 5, 8), (200, 328, 1000)[i % 3], N, bits, dtype,
                             block, torch.bfloat16, False, qk.qmatmul_gemv_tc)
        for block in ((16, 24, 40) if bits == 4 else (8, 12, 20)):
            check_b1((1, 4, 8), 200, 70, bits, "float", block, torch.bfloat16, False,
                     qk.qmatmul_gemv_tc)
    require(qk.qmatmul_gemv_tc.launches - before_tc == 3 * (3 * 3 * 5 * 6 + 3 * 3),
            "the tensor-core GEMV's edge grid did not launch once per case")
    cfg = get_arch(ARCH)
    D, F, KD, V = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim, cfg.vocab_size
    shapes = [(D, D), (D, KD), (D, F), (F, D), (D, V)]
    for K, N in shapes:
        check_b1((BATCH, BATCH * PROMPT), K, N, 4, "float", 64, torch.bfloat16, True)
        check_b1((BATCH,), K, N, 4, "float", 64, torch.float32, False)
    # the tensor-core kernel's edges: rows around its 64-row slabs and its
    # 128- and 256-row tiles, columns around its 128-column tiles and off
    # 16-byte rows, every bit width with blocks that words straddle; the
    # Qwen2-7B k/v shape at M = 1024 splits K
    for bits, block in ((3, 16), (4, 32), (5, 64), (6, 16), (7, 16), (8, 32)):
        for N in (8, 70, 136, 512):
            check_b1((9, 63, 64, 65, 129), 200, N, bits, "int", block, torch.bfloat16, False)
            check_b1((1024,), 640, N, bits, "int", block, torch.bfloat16, False)
    # the paper sweep's matrices at its perplexity batch (M = 1024): fig2's
    # bit widths, fig3dt's data types and fig3bs's blocks that divide a row
    from repro_torch.configs.tiny import TINY_FAMILY

    for tcfg in TINY_FAMILY.values():
        Dt, Ft = tcfg.d_model, tcfg.d_ff
        for K, N in ((Dt, Dt), (Dt, Ft), (Ft, Dt)):
            cases = [(b, "float", 64) for b in (3, 4, 5, 6, 8)]
            cases += [(4, dt, 64) for dt in ("int", "dynamic", "quantile")]
            cases += [(b, "float", B) for b in (4, 8) for B in (32, 128, 256, 1024) if K % B == 0]
            for bits, dtype, block in cases:
                check_b1((1024,), K, N, bits, dtype, block, torch.bfloat16, True)

    rows = BATCH * (PROMPT + NEW_TOKENS)
    for bits in (4, 8):
        for dtype in ("int", "float", "dynamic"):
            # the main path's rows, a short row, and 6-wide blocks that words straddle
            for R, feat, block in ((rows, KD, 64), (3, 64, 64), (5, 48, 6)):
                spec = kvd.KVQuantSpec(bits=bits, block_size=block, dtype_name=dtype)
                x = torch.randn((R, feat), generator=g, device=dev).to(torch.bfloat16)
                packed, scales = kvd.encode_rows(x, spec)
                out_k = kvd.dequant_rows_cuda(packed, scales, spec, feat)
                out_p = kvd.dequant_rows_ref(packed, scales, spec, feat)
                torch.cuda.synchronize()
                require(torch.equal(out_k.view(torch.int16), out_p.view(torch.int16)),
                        f"kv_dequant kv{bits} {dtype} R={R} feat={feat} b{block} not bit-exact")
                n_checks += 1
    def check_b3(xb, cb, what):
        nonlocal n_checks
        kc, ks = quantk.quantize_blocks_cuda(xb, cb)
        pc, ps = quantk.quantize_blocks_plain(xb, cb)
        torch.cuda.synchronize()
        require(torch.equal(kc, pc) and torch.equal(ks.view(torch.int32), ps.view(torch.int32)),
                f"quantize_blocks {what}: codes or scale bits differ")
        worst["b3"] = max(worst["b3"], float((kc - pc).abs().max()),
                          float((ks - ps).abs().max()))
        n_checks += 1

    # blocks holding codebook values and exact midpoints (absmax a power of
    # two, so x / scale is exact), then random blocks and a partial last block
    for bits in (3, 4, 5, 6, 8):
        for dtype in ("int", "float", "dynamic", "quantile"):
            base = torch.randn((4096,), generator=g, device=dev)
            cb = make_codebook(dtype, bits, tensor=base)
            special = torch.cat([cb, (cb[:-1] + cb[1:]) / 2.0])
            special = torch.cat([special, -special])
            for block in (16, 32, 48, 64, 128, 1024):
                chunks = special.split(block - 1)
                heads = torch.ones((len(chunks), 1), device=dev)
                rows = torch.nn.utils.rnn.pad_sequence(list(chunks), batch_first=True)
                rows = torch.nn.functional.pad(rows, (0, block - 1 - rows.shape[1]))
                scale = 2.0 ** torch.randint(-6, 3, (len(chunks), 1), generator=g, device=dev)
                exact = (torch.cat([heads, rows], dim=1) * scale).reshape(-1)
                n_rand = 300 * block + block // 2 + 1
                rand = torch.randn((n_rand,), generator=g, device=dev) * torch.exp(
                    2 * torch.randn((n_rand // block + 1, 1), generator=g, device=dev)
                ).expand(-1, block).reshape(-1)[:n_rand]
                x = torch.cat([exact, rand])
                n_blocks = -(-x.numel() // block)
                xb = torch.nn.functional.pad(x, (0, n_blocks * block - x.numel()))
                check_b3(xb.reshape(n_blocks, block), cb, f"{bits}-bit {dtype} b{block}")
    # the main path's items: each Qwen2-7B matrix shape as the encode sees it
    cb = make_codebook("float", 4, device=dev)
    for rows, cols in _qwen_items(cfg):
        w = torch.randn((rows, cols), generator=g, device=dev).to(torch.bfloat16)
        check_b3(w.reshape(-1).float().reshape(-1, 64), cb, f"Qwen2-7B item {rows}x{cols}")
        del w
    n_checks += check_pack(torch, dev, g, cfg, worst)
    n_checks += check_attention(torch, dev, g, cfg, worst)
    emit({"phase": "kernels", "checks": n_checks, "max_abs_err_main_shapes": worst,
          "tolerance": {"f32_rel": F32_REL_TOL, "bf16_rel_to_max": BF16_REL_TOL,
                        "kv_dequant": "bit-exact", "quantize_blocks": "bit-exact",
                        "quantize_pack": "bit-exact",
                        "kv_decode_attention_rel_to_row_max": ATT_REL_TOL}})
    return worst


def _pack_rows(torch, dev, g, cb, rows, cols, block):
    """[rows, cols] f32: blocks that hold the codebook's values and exact
    midpoints (absmax a power of two, so x / scale is exact), an all-zero
    row, then random rows of mixed scale."""
    special = torch.cat([cb, (cb[:-1] + cb[1:]) / 2.0])
    special = torch.cat([special, -special])
    chunks = special.split(block - 1)
    blocks = []
    for c in chunks:
        head = torch.ones(1, device=dev)
        blk = torch.nn.functional.pad(torch.cat([head, c]), (0, block - 1 - c.numel()))
        blocks.append(blk * 2.0 ** int(torch.randint(-6, 3, (1,), generator=g, device=dev)))
    flat = torch.cat(blocks)
    flat = torch.nn.functional.pad(flat, (0, -(-flat.numel() // cols) * cols - flat.numel()))
    exact = flat.reshape(-1, cols)[: rows // 2]
    rand = torch.randn((rows, cols), generator=g, device=dev) * torch.exp(
        2 * torch.randn((rows, 1), generator=g, device=dev))
    rand[: exact.shape[0]] = exact
    rand[rows - 1] = 0.0
    return rand


def check_pack(torch, dev, g, cfg, worst) -> int:
    """The encode to the stored form against its plain version: bit-exact
    words and scale bits over 3 to 8 bits, blocks 16 to 1024, the four data
    types, bf16 and f32 items, both layouts, odd row counts and word tails;
    then Qwen2-7B's five item shapes as the serve phase stores them."""
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import quantize as quantk

    n = 0

    def one(stored, cb, bits, block, transposed, what):
        nonlocal n
        kp, ks = quantk.quantize_pack_cuda(stored, cb, bits=bits, block_size=block,
                                           transposed=transposed)
        pp, ps = quantk.quantize_pack_plain(stored, cb, bits=bits, block_size=block,
                                            transposed=transposed)
        torch.cuda.synchronize()
        require(torch.equal(kp, pp) and torch.equal(ks.view(torch.int16), ps.view(torch.int16)),
                f"quantize_pack {what}: words or scale bits differ")
        worst["pack"] = max(worst["pack"], float((kp.long() - pp.long()).abs().max()),
                            float((ks.float() - ps.float()).abs().max()))
        n += 1

    for bits in range(3, 9):
        for dtype in ("int", "float", "dynamic", "quantile"):
            base = torch.randn((4096,), generator=g, device=dev)
            cb = make_codebook(dtype, bits, tensor=base)
            for block in (16, 32, 64, 128, 1024):
                rows, cols = (37, 3 * block) if block < 1024 else (9, 2 * block)
                w = _pack_rows(torch, dev, g, cb, rows, cols, block)
                for xdt in (torch.float32, torch.bfloat16):
                    x = w.to(xdt)
                    for transposed in (False, True):
                        stored = x.T.contiguous() if transposed else x
                        one(stored, cb, bits, block, transposed,
                            f"{bits}-bit {dtype} b{block} {xdt} transposed={transposed}")
    cb = make_codebook("float", 4, device=dev)
    for rows, cols in _qwen_items(cfg):
        transposed = rows != cfg.vocab_size
        shape = (cols, rows) if transposed else (rows, cols)
        stored = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        one(stored, cb, 4, 64, transposed, f"Qwen2-7B item {rows}x{cols}")
        del stored
        torch.cuda.empty_cache()
    return n


def _random_cache(torch, dev, g, spec, B, S, feat, n_holes=0):
    """A packed cache of S slots, every slot written, n_holes of them
    marked empty (pos -1)."""
    from repro_torch.kernels import kv_dequant as kvd

    cache = {}
    for name in ("k", "v"):
        x = torch.randn((B, S, feat), generator=g, device=dev).to(torch.bfloat16)
        cache[f"{name}_packed"], cache[f"{name}_scales"] = kvd.encode_rows(x, spec)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    if n_holes:
        holes = torch.randperm(S, generator=g, device=dev)[:n_holes]
        pos[holes] = -1
    cache["pos"] = pos
    return cache


def check_attention(torch, dev, g, cfg, worst) -> int:
    """The fused decode attention against its plain version, per (batch
    row, head) within ATT_REL_TOL of the row's max: kv4 and kv8, 1 to 4096
    slots, empty slots and pos short of the last slot, batch 1 and 4, at
    Qwen2-7B's heads and at tiny-650k's (kv_tol's model); a cache of
    MULTI_ROUND slots, whose CTA shares take more than one round of the
    kernel's shared memory; and a logit soft-cap at 17 and 288 slots."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd

    n = 0
    tiny = get_arch("tiny-650k")
    for c in (cfg, tiny):
        K, Dh, H = c.n_kv_heads, c.head_dim, c.n_heads
        for bits in (4, 8):
            spec = kvd.KVQuantSpec(bits=bits, block_size=c.kv_block_size, dtype_name="float")
            for S, batches, caps in ((1, (1, 4), (0.0,)), (17, (1, 4), (0.0, SOFTCAP)),
                                     (288, (1, 4), (0.0, SOFTCAP)),
                                     (LONG_CONTEXT, (1, 4), (0.0,)), (MULTI_ROUND, (1,), (0.0,))):
                for B, cap in itertools.product(batches, caps):
                    cache = _random_cache(torch, dev, g, spec, B, S, K * Dh, n_holes=S // 5)
                    q = torch.randn((B, H, Dh), generator=g, device=dev).to(torch.bfloat16)
                    for pos in sorted({S - 1, max(0, S - 3)}):
                        out = kat.decode_attention_packed_cuda(q, cache, pos, spec,
                                                               cap=cap).float()
                        ref = kat.decode_attention_packed_plain(q, cache, pos, spec,
                                                                cap=cap).float()
                        torch.cuda.synchronize()
                        gap = (out - ref).abs().amax(-1)
                        lim = ATT_REL_TOL * ref.abs().amax(-1)
                        require(bool(torch.isfinite(out).all()) and bool((gap <= lim).all()),
                                f"kv_decode_attention {c.name} kv{bits} S={S} B={B} pos={pos} "
                                f"cap={cap}: max gap {float(gap.max())} over the row's "
                                f"2^-6 * max")
                        if c is cfg:
                            worst["attn"] = max(worst["attn"], float(gap.max()))
                        n += 1
    return n


def _qwen_items(cfg) -> dict:
    """{(rows, cols): encodes in one whole-model quantization} over the
    distinct shapes of Qwen2-7B's quantized matrices as stored (out, in):
    wq/wo, wk/wv, w_gate/w_up, w_down, lm_head."""
    D, F, KD, V = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim, cfg.vocab_size
    L = cfg.n_layers
    return {(D, D): 2 * L, (KD, D): 2 * L, (F, D): 2 * L, (D, F): L,
            (V, D): 0 if cfg.tie_embeddings else 1}


def _counts():
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import qmatmul as qk

    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import quantize as quantk

    return {"gemv": qk.qmatmul_gemv.launches, "gemv_tc": qk.qmatmul_gemv_tc.launches,
            "gemv_simt": qk.qmatmul_gemv_simt.launches, "gemm": qk.qmatmul_gemm.launches,
            "gemm_simt": qk.qmatmul_gemm.simt_launches, "kv": kvd.dequant_rows_cuda.launches,
            "attn": kat.decode_attention_packed_cuda.launches,
            "b3": quantk.quantize_blocks_cuda.launches,
            "pack": quantk.quantize_pack_cuda.launches}


def _reset_counts():
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels import quantize as quantk

    qk.qmatmul_gemv.launches = 0
    qk.qmatmul_gemv_tc.launches = 0
    qk.qmatmul_gemv_simt.launches = 0
    qk.qmatmul_gemm.launches = 0
    qk.qmatmul_gemm.simt_launches = 0
    kvd.dequant_rows_cuda.launches = 0
    kat.decode_attention_packed_cuda.launches = 0
    quantk.quantize_blocks_cuda.launches = 0
    quantk.quantize_pack_cuda.launches = 0


def serve_main_path(torch, dev) -> dict:
    """Phase 3: Qwen2-7B served by Engine through the kernels."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params
    from repro_torch.serving import Engine

    cfg = get_arch(ARCH).with_kv_quant(KV_BITS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _reset_counts()
    # the quantization's own peak (the init's transients peak higher)
    init_peak_bytes = torch.cuda.max_memory_allocated()
    params_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64),
                              cfg, device=dev)
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    quantize_peak_bytes = torch.cuda.max_memory_allocated()
    per_layer = 7   # wq, wk, wv, wo, w_gate, w_up, w_down
    quant_counts = _counts()
    n_items = per_layer * cfg.n_layers + (0 if cfg.tie_embeddings else 1)   # + lm_head
    require(quant_counts == {"gemv": 0, "gemv_tc": 0, "gemv_simt": 0, "gemm": 0,
                             "gemm_simt": 0, "kv": 0, "attn": 0, "b3": 0, "pack": n_items},
            f"quantize_params launched {quant_counts}, want {n_items} quantize_pack launches")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=_gen(torch, dev, SEED + 2),
                            device=dev)
    engine = Engine(qparams, cfg, max_seq_len=PROMPT + NEW_TOKENS, device=dev)

    # prefill alone (and the first token), then the full run with counts
    engine.generate(prompts, 1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    engine.generate(prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t3
    _reset_counts()
    t4 = time.perf_counter()
    tokens = engine.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t4
    counts = _counts()
    peak_bytes = max(init_peak_bytes, torch.cuda.max_memory_allocated())
    n_steps = NEW_TOKENS - 1
    b1_step = per_layer * cfg.n_layers + 1
    b2_step = cfg.n_layers   # one fused attention a layer
    require(tuple(tokens.shape) == (BATCH, NEW_TOKENS), f"tokens shape {tuple(tokens.shape)}")
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens out of range")
    require(counts["gemm"] == per_layer * cfg.n_layers,
            f"prefill: {counts['gemm']} tiled qmatmul launches")
    require(counts["gemv"] == 1 + n_steps * b1_step,
            f"{counts['gemv']} GEMV launches, want 1 + {n_steps} x {b1_step}")
    require(counts["gemv_tc"] == counts["gemv"],
            f"{counts['gemv_tc']} of {counts['gemv']} GEMV launches on the tensor cores")
    require(counts["attn"] == n_steps * b2_step and counts["kv"] == 0,
            f"{counts['attn']} fused attention and {counts['kv']} kv dequant launches, want "
            f"{n_steps} x {b2_step} and 0")

    # one more prefill and decode step with logits in hand
    logits, caches = lm.prefill(qparams, prompts, cfg, cache_len=PROMPT + NEW_TOKENS)
    _reset_counts()
    step_logits, _ = lm.decode_step(qparams, tokens[:, 0], caches, PROMPT, cfg)
    torch.cuda.synchronize()
    step_counts = _counts()
    require(bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all()),
            "non-finite logits")
    require(step_counts == {"gemv": b1_step, "gemv_tc": b1_step, "gemv_simt": 0, "gemm": 0,
                            "gemm_simt": 0, "kv": 0, "attn": b2_step, "b3": 0, "pack": 0},
            f"one decode step launched {step_counts}")
    # the same step's device time alone: replayed from a CUDA graph, without
    # the host's eager PyTorch overhead that the step above includes
    step_device_ms = _time_ms(
        torch, lambda: lm.decode_step(qparams, tokens[:, 0], caches, PROMPT, cfg), 5)
    del caches, logits, step_logits
    emit({"phase": "serve", "arch": ARCH, "depth": cfg.n_layers, "width": cfg.d_model,
          "weights": "4-bit float b64", "kv_bits": KV_BITS, "batch": BATCH,
          "prompt_len": PROMPT, "new_tokens": NEW_TOKENS,
          "init_s": t1 - t0, "quantize_s": t2 - t1, "prefill_s": prefill_s,
          "decode_ms_per_step": (total_s - prefill_s) / n_steps * 1e3,
          "decode_step_device_ms": step_device_ms,
          "tokens_per_s": BATCH * NEW_TOKENS / total_s, "generate_s": total_s,
          "max_memory_allocated_bytes": peak_bytes,
          "quantize_peak_bytes": quantize_peak_bytes,
          "quantize_peak_over_bf16_params_bytes": quantize_peak_bytes - params_bytes,
          "launches": counts, "launches_per_decode_step": step_counts,
          "launches_quantize": quant_counts})
    require(counts["b3"] == counts["pack"] == 0, f"generate launched encodes: {counts}")
    counts["b3"], counts["pack"] = quant_counts["b3"], quant_counts["pack"]
    return {"cfg": cfg, "qparams": qparams, "prompts": prompts, "counts": counts}


def mode_parity(torch, dev, run) -> float:
    """Phase 4: teacher-forced logits, fused kernel vs dequant_einsum."""
    from repro_torch.models import lm

    cfg, qparams, prompts = run["cfg"], run["qparams"], run["prompts"]
    out = {}
    with torch.inference_mode():
        for mode in ("fused", "dequant_einsum"):
            c = cfg.with_matmul_mode(mode)
            h, _ = lm.backbone_seq(qparams, prompts, c)
            out[mode] = lm.logits_from_hidden(qparams, h, c).float()
    gap = float((out["fused"] - out["dequant_einsum"]).abs().max())
    require(bool(torch.isfinite(out["fused"]).all()), "non-finite fused logits")
    require(gap <= MODE_GAP_TOL, f"fused vs dequant_einsum logit gap {gap} > {MODE_GAP_TOL}")
    emit({"phase": "modes", "max_abs_logit_gap": gap, "gate": MODE_GAP_TOL,
          "max_abs_logit": float(out["fused"].abs().max()),
          "argmax_agreement": float((out["fused"].argmax(-1) == out["dequant_einsum"].argmax(-1))
                                    .float().mean())})
    return gap


def kv_tolerance(torch, dev) -> dict:
    """Phase 5: the reference's stated KV tolerance on tiny-650k."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params
    from repro_torch.serving import KV_LOGIT_TOL, kv_oracle_logit_gap

    cfg = get_arch("tiny-650k")
    params = quantize_params(lm.init_params(cfg, seed=SEED, device=dev),
                             QuantConfig(bits=4), cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 10), generator=_gen(torch, dev, SEED + 3),
                            device=dev)
    gaps = {}
    for bits in (8, 4):
        before = _counts()["attn"]
        gap, agree = kv_oracle_logit_gap(params, cfg.with_kv_quant(bits), prompts, 8, device=dev)
        require(_counts()["attn"] > before, "fused decode attention not in the loop")
        require(gap <= KV_LOGIT_TOL[bits], f"kv{bits} logit gap {gap} > {KV_LOGIT_TOL[bits]}")
        gaps[bits] = {"gap": gap, "greedy_agreement": agree, "tol": KV_LOGIT_TOL[bits]}
    emit({"phase": "kv_tol", "arch": "tiny-650k", "weights": "4-bit float b64", "kv": gaps})
    return gaps


def paper_path(torch, dev) -> dict:
    """Phase 6: the paper's sweep on the card, through the port's own entry
    points: train the tiny ladder, then fig2, fig3 data types and fig3 block
    sizes on it (every encode through the kernel, every quantized matmul
    through the fused GEMM)."""
    import math

    from repro_torch.data.synthetic import ZipfMarkov
    from repro_torch.paper import common, fig2_bitlevel, fig3_blocksize, fig3_datatypes

    def log(*args):
        print(*args, file=sys.stderr, flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    family = common.trained_family(log=log, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, fig2 = fig2_bitlevel.run(family, log=log)
    _, ranking = fig3_datatypes.run(family, log=log)
    _, block_effect = fig3_blocksize.run(family, log=log)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counts()

    models = {}
    for name, t in family.items():
        models[name] = {"first_loss": t.history[0], "last_loss": t.history[-1],
                        "steps": len(t.history),
                        "entropy_floor": ZipfMarkov(t.cfg.vocab_size, device=dev).entropy_floor()}
        require(all(math.isfinite(v) for v in t.history), f"{name}: non-finite training loss")
        require(t.history[-1] <= t.history[0] - MIN_LOSS_DROP,
                f"{name}: loss {t.history[0]} -> {t.history[-1]}, not {MIN_LOSS_DROP} nat lower")
    ppl = {}
    for o in fig2["observations"]:
        ppl.setdefault(o["model"], {})[o["precision"]] = math.exp(o["log_ppl"])
    for name, by_k in ppl.items():
        require(all(math.isfinite(v) for v in by_k.values()), f"{name}: non-finite perplexity")
        rel = abs(by_k[8] / by_k[16] - 1.0)
        require(rel <= PPL_K8_REL_TOL, f"{name}: 8-bit perplexity {by_k[8]} is {rel:.4f} "
                                        f"off 16-bit {by_k[16]}")
    require(counts["pack"] > 0 and counts["gemm"] > 0,
            f"the sweep did not run through the encode kernel and the fused GEMM: {counts}")
    emit({"phase": "paper", "recipe": common.TRAIN_RECIPE, "models": models,
          "fig2_ppl": ppl, "fig2_optimal_precision": fig2["optimal_precision"],
          "fig2_wins": fig2["wins"], "fig3dt_ranking": ranking,
          "fig3bs_mean_degradation": block_effect, "launches": counts,
          "train_s": t1 - t0, "sweep_s": t2 - t1, "seconds": t2 - t0,
          "gates": {"min_loss_drop_nats": MIN_LOSS_DROP, "ppl_k8_rel": PPL_K8_REL_TOL}})
    return {"launches": counts}


def _time_ms(torch, fn, reps: int) -> float:
    """Device time of one call of fn (a sequence of launches): fn runs once,
    is captured in a CUDA graph, and the median of reps graph replays is
    taken by CUDA events.  Replaying the graph leaves the host's Python and
    launch overhead out of the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    torch.cuda.empty_cache()
    times.sort()
    return times[len(times) // 2]


def _bound(nbytes: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, dev, run) -> dict:
    """Phase 7: the kernels at the main path's shapes, one decode step's and
    one prefill's worth of launches over the real quantized layers."""
    from repro_torch.core.qtensor import dequantize_tensor
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.models.blocks import take

    cfg, qparams, counts = run["cfg"], run["qparams"], run["counts"]
    names = [("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
             ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
    stack = qparams["stack"][0]
    layers = [take(stack, i) for i in range(cfg.n_layers)]
    qts = [layers[i][a][b]["w"] for i in range(cfg.n_layers) for a, b in names]
    g = _gen(torch, dev, SEED + 4)

    def plan(M, with_head):
        items = qts + ([qparams["lm_head"]] if with_head else [])
        xs = {}
        calls = []
        nbytes = flops = 0.0
        for qt in items:
            op = ops.operand_from_qtensor(qt)
            N, K = qt.quant_shape
            if K not in xs:
                xs[K] = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            xp, packed, scales = ops.pad_for_kernel(xs[K], op)
            calls.append((xp, packed, scales, op, xs[K]))
            nbytes += (packed.numel() * 4 + scales.numel() * 2 + op.codebook.numel() * 4
                       + M * K * 2 + M * N * 2)
            flops += 2.0 * M * N * K
        return calls, nbytes, flops

    def b1(calls, fn):
        def go():
            for xp, packed, scales, op, _ in calls:
                fn(xp, packed, scales, op.codebook, bits=op.bits, block_size=op.block_size)
        return go

    out = {}
    shapes_ms = {}
    rep_b1 = "src/repro/kernels/qmatmul.py:97"
    # the decode GEMV routes every serving operand to the tensor cores; the
    # CUDA-core GEMV (qmatmul_gemv_simt) is timed beside it on the same ones
    for name, src_b1, M, with_head, fn, old, reps in (
            ("qmatmul_gemv", "src/repro_torch/csrc/qgemv_sm90.cu", BATCH, True, qk.qmatmul_gemv,
             qk.qmatmul_gemv_simt, 10),
            ("qmatmul_gemm", "src/repro_torch/csrc/qgemm_sm90.cu", BATCH * PROMPT, False,
             qk.qmatmul_gemm, None, 3)):
        calls, nbytes, flops = plan(M, with_head)
        ms = _time_ms(torch, b1(calls, fn), reps)
        old_ms = _time_ms(torch, b1(calls, old), reps) if old else None
        plain_ms = _time_ms(torch, b1(calls, qk.qmatmul_plain), 2)
        dense = [dequantize_tensor(op_qt, out_dtype=torch.bfloat16)
                 for op_qt in (qts + ([qparams["lm_head"]] if with_head else []))]

        def lib(pairs):
            def go():
                for (_, _, _, _, x), w in pairs:
                    torch.matmul(x, w.T)
            return go
        library_ms = _time_ms(torch, lib(list(zip(calls, dense))), reps)
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = {"source": src_b1, "replaces": rep_b1,
                     "launches": (counts["gemv_tc"] if name == "qmatmul_gemv"
                                  else counts["gemm"] - counts["gemm_simt"]),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "cuda_core_gemv_ms": old_ms,
                     "per": "decode step (197 launches)" if with_head
                     else "prefill (196 launches)", "M": M, "bytes": nbytes, "flops": flops}
        if old:
            out["qmatmul_gemv_simt"] = {
                "source": "src/repro_torch/csrc/qmatmul.cu", "replaces": rep_b1,
                "launches": counts["gemv_simt"], "ms": old_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "per": "a decode step's operands (197 launches)"}
        per_shape = shapes_ms.setdefault(f"{name}_M{M}", {})
        for K, N in sorted({(c[3].k_dim, c[1].shape[0]) for c in calls}):
            pick = [i for i, c in enumerate(calls) if c[3].k_dim == K and c[1].shape[0] == N]
            sub = [calls[i] for i in pick]
            sub_ms = _time_ms(torch, b1(sub, fn), reps) / len(sub)
            sub_lib = _time_ms(torch, lib([(calls[i], dense[i]) for i in pick]), reps) / len(sub)
            sb = sub[0][1].numel() * 4 + sub[0][2].numel() * 2 + M * K * 2 + M * N * 2
            per_shape[f"{K}x{N}"] = {"ms_per_call": sub_ms, "library_ms_per_call": sub_lib,
                                     "bound_ms_per_call": _bound(sb, 2.0 * M * N * K)[0],
                                     "calls": len(sub)}
            if old:
                per_shape[f"{K}x{N}"]["cuda_core_gemv_ms_per_call"] = (
                    _time_ms(torch, b1(sub, old), reps) / len(sub))
        del calls, dense

    spec = kvd.kv_spec(cfg)
    feat = cfg.n_kv_heads * cfg.head_dim
    rows = BATCH * (PROMPT + NEW_TOKENS)
    leaves = []
    for _ in range(2 * cfg.n_layers):
        x = torch.randn((BATCH, PROMPT + NEW_TOKENS, feat), generator=g, device=dev)
        leaves.append(kvd.encode_rows(x.to(torch.bfloat16), spec))

    def kv(fn):
        def go():
            for packed, scales in leaves:
                fn(packed.reshape(rows, -1), scales.reshape(rows, -1), spec, feat)
        return go

    packed0, scales0 = leaves[0]
    kv_bytes = len(leaves) * (packed0.numel() * 4 + scales0.numel() * 2 + rows * feat * 2
                              + 4 * 2 ** spec.bits)
    kv_bound, kv_by = _bound(kv_bytes, 0.0)
    out["kv_dequant"] = {
        "source": "src/repro_torch/csrc/kv_dequant.cu",
        "replaces": "src/repro/kernels/kv_dequant.py:159", "launches": counts["kv"],
        "ms": _time_ms(torch, kv(kvd.dequant_rows_cuda), 20),
        "plain_ms": _time_ms(torch, kv(kvd.dequant_rows_ref), 5),
        "bound_ms": kv_bound, "bound_by": kv_by, "library_ms": None,
        "per": "a decode step's caches (56 launches; the decode path now reads them through "
               "kv_decode_attention)", "bytes": kv_bytes}
    out["kv_decode_attention"] = _time_attention(torch, dev, cfg, counts["attn"], g)
    out["qgemm_simt"] = _time_gemm_simt(torch, dev, counts["gemm_simt"], g)
    out["quantize_blocks"], out["quantize_pack"], shapes_ms["encode_B64"] = _time_encode(
        torch, dev, cfg, counts, g)
    emit({"phase": "times", "card_rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                                           "bf16_flop_per_s": BF16_FLOP_PER_S,
                                           "f32_flop_per_s": F32_FLOP_PER_S},
          "kernels": out, "per_shape": shapes_ms,
          "library_note": {"qmatmul": "torch.matmul on the pre-dequantized weight",
                           "kv_dequant": "no single PyTorch call computes it",
                           "kv_decode_attention": "no single PyTorch call computes it",
                           "quantize": "no single PyTorch call computes either encode"}})
    return out


def _time_attention(torch, dev, cfg, launches, g):
    """The fused decode attention over one decode step (one launch a layer,
    each layer its own random packed cache, batch 4, every slot valid) at
    the serve phase's slots and at LONG_CONTEXT, and at ONE_TILE for its
    fixed cost a launch (what does not grow with slots), beside the path it replaced
    (two standalone KV dequant launches a layer and the eager attention) and
    its plain version."""
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.models import attention as attn

    spec = kvd.kv_spec(cfg)
    shape = (BATCH, -1, cfg.n_kv_heads, cfg.head_dim)
    K, Dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    by_slots = {}
    for S in (ONE_TILE, PROMPT + NEW_TOKENS, LONG_CONTEXT):
        caches = [_random_cache(torch, dev, g, spec, BATCH, S, K * Dh)
                  for _ in range(cfg.n_layers)]
        q = torch.randn((BATCH, H, Dh), generator=g, device=dev).to(torch.bfloat16)

        def step(fn):
            def go():
                for c in caches:
                    fn(c)
            return go

        def replaced(c):
            k = kvd.dequant_rows(c["k_packed"], c["k_scales"], spec, K * Dh).reshape(shape)
            v = kvd.dequant_rows(c["v_packed"], c["v_scales"], spec, K * Dh).reshape(shape)
            m, l, pv = attn.decode_attention_partial(q, k, v, c["pos"], S - 1)
            return attn.combine_partials(m, l, pv).reshape(q.shape).to(q.dtype)

        c0 = caches[0]
        nbytes = cfg.n_layers * (sum(t.numel() * t.element_size() for t in c0.values())
                                 + 2 * q.numel() * 2 + 4 * 2 ** spec.bits)
        flops = cfg.n_layers * 4.0 * BATCH * H * S * Dh
        bound_ms, bound_by = _bound(nbytes, flops)
        by_slots[S] = {
            "ms": _time_ms(torch, step(lambda c: kat.decode_attention_packed_cuda(
                q, c, S - 1, spec)), 20),
            "replaced_ms": _time_ms(torch, step(replaced), 5),
            "plain_ms": _time_ms(torch, step(lambda c: kat.decode_attention_packed_plain(
                q, c, S - 1, spec)), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        del caches
        torch.cuda.empty_cache()
    main = by_slots[PROMPT + NEW_TOKENS]
    return {"source": "src/repro_torch/csrc/kv_decode_attention.cu",
            "replaces": "src/repro/kernels/kv_dequant.py:159", "launches": launches,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "per": f"decode step ({cfg.n_layers} launches, {PROMPT + NEW_TOKENS} slots)",
            "replaced_ms": main["replaced_ms"], "by_slots": by_slots}


def _time_gemm_simt(torch, dev, launches, g):
    """B1's f32 CUDA-core GEMM (qgemm_simt) at the sweep's GEMM shapes: each
    tiny-ladder matrix once at M = 1024 (4-bit float, block 64) with f32 x,
    beside its plain version and torch.matmul on the same f32 operands (the
    weight dequantized to f32); bound by f32 operations outside the tensor
    cores or by bytes."""
    from repro_torch.configs.tiny import TINY_FAMILY
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels.ref import dequantize_operand

    M = 1024
    calls = []
    nbytes = flops = 0.0
    for tcfg in TINY_FAMILY.values():
        D, F = tcfg.d_model, tcfg.d_ff
        for K, N in ((D, D), (D, F), (F, D)):
            w = torch.randn((K, N), generator=g, device=dev) * 0.05
            op = ops.prepare_operand(w, bits=4, dtype="float", block_size=64)
            x = torch.randn((M, K), generator=g, device=dev)
            xp, packed, scales = ops.pad_for_kernel(x, op)
            calls.append((xp, packed, scales, op, dequantize_operand(op)))
            nbytes += packed.numel() * 4 + scales.numel() * 2 + xp.numel() * 4 + M * N * 4
            flops += 2.0 * M * N * xp.shape[1]

    def run(fn):
        def go():
            for xp, packed, scales, op, _ in calls:
                fn(xp, packed, scales, op.codebook, bits=op.bits, block_size=op.block_size)
        return go

    def lib():
        for xp, _, _, _, wd in calls:
            torch.matmul(xp, wd.T)

    bound_ms, bound_by = _bound(nbytes, flops, F32_FLOP_PER_S)
    return {"source": "src/repro_torch/csrc/qmatmul.cu", "replaces": "src/repro/kernels/qmatmul.py:97",
            "launches": launches, "ms": _time_ms(torch, run(qk.qmatmul_gemm), 5),
            "plain_ms": _time_ms(torch, run(qk.qmatmul_plain), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": _time_ms(torch, lib, 5),
            "per": f"the sweep's {len(calls)} GEMM shapes once each, M = {M}, f32 x",
            "bytes": nbytes, "flops": flops}


def _peak_extra(torch, fn) -> int:
    """Peak device memory fn takes above what is allocated when it starts."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _old_encode_chain(view, cb, bits: int, block: int):
    """The route quantize_pack replaced, from a 2-D item to its stored
    form: blockwise.encode (a copy to padded f32 blocks, the old encode
    kernel, casts), packing.pack of the flat codes, then to_structured's row
    repack (an unpack and a second pack where rows end inside a word)."""
    from repro_torch.core import blockwise, packing

    rows, cols = view.shape
    q = blockwise.encode(view, cb, block)
    words = packing.pack(q.codes.reshape(-1), bits)
    if cols % packing.codes_per_word(bits):
        words = packing.pack(packing.unpack(words, bits, rows * cols).reshape(rows, cols), bits)
    return words.reshape(rows, -1), q.scales.reshape(rows, cols // block)


def _time_encode(torch, dev, cfg, counts, g):
    """Both encode kernels at each Qwen2-7B item shape (4-bit float, block
    64), per launch and summed over one whole-model encode (one launch per
    quantized matrix: 7 per layer and the lm_head): quantize_blocks on its
    f32 blocks (its contract), quantize_pack from the stored bf16 weight
    beside the chain it replaced (_old_encode_chain: copies, casts and
    packing around the old kernel), which must store the same words."""
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import quantize as quantk

    cb = make_codebook("float", 4, device=dev)
    per_shape = {}
    keys = ("b3_ms", "b3_plain_ms", "b3_bound_ms", "b3_bytes", "ms", "plain_ms", "chain_ms",
            "bound_ms", "bytes")
    peaks = {"peak_extra_bytes": 0, "chain_peak_extra_bytes": 0}   # largest item's
    tot = dict.fromkeys(keys, 0.0)
    for (rows, cols), n in _qwen_items(cfg).items():
        transposed = rows != cfg.vocab_size   # the matrices are stored [In, Out]
        stored = torch.randn((cols, rows) if transposed else (rows, cols), generator=g,
                             device=dev).to(torch.bfloat16)
        view = stored.T if transposed else stored
        xb = view.reshape(-1).float().reshape(-1, 64)
        r = {"b3_ms": _time_ms(torch, lambda: quantk.quantize_blocks_cuda(xb, cb), 10),
             "b3_plain_ms": _time_ms(torch, lambda: quantk.quantize_blocks_plain(xb, cb), 3),
             # its contract's bytes: 4 in and 4 of code per value, 4 of scale per block
             "b3_bytes": xb.numel() * 8 + xb.shape[0] * 4 + cb.numel() * 4}
        del xb
        kw = dict(bits=4, block_size=64, transposed=transposed)
        r["ms"] = _time_ms(torch, lambda: quantk.quantize_pack_cuda(stored, cb, **kw), 10)
        r["plain_ms"] = _time_ms(torch, lambda: quantk.quantize_pack_plain(stored, cb, **kw), 2)
        old = _old_encode_chain(view, cb, 4, 64)
        new = quantk.quantize_pack_cuda(stored, cb, **kw)
        require(all(torch.equal(a, b) for a, b in zip(old, new)),
                f"quantize_pack and the chain it replaced store different words at {rows}x{cols}")
        del old, new
        r["chain_ms"] = _time_ms(torch, lambda: _old_encode_chain(view, cb, 4, 64), 2)
        # device memory one call takes beyond its input, outputs included
        r["peak_extra_bytes"] = _peak_extra(torch, lambda: quantk.quantize_pack_cuda(
            stored, cb, **kw))
        r["chain_peak_extra_bytes"] = _peak_extra(torch, lambda: _old_encode_chain(
            view, cb, 4, 64))
        # 2 bytes in, a packed word per 8 codes and a bf16 scale per block out
        r["bytes"] = rows * cols * 2 + rows * (cols // 8) * 4 + rows * (cols // 64) * 2 \
            + cb.numel() * 4
        r["b3_bound_ms"] = _bound(r["b3_bytes"], 0.0)[0]
        r["bound_ms"] = _bound(r["bytes"], 0.0)[0]
        per_shape[f"{rows}x{cols}"] = {**r, "per_model_encode": n, "transposed": transposed}
        for k in keys:
            tot[k] += n * r[k]
        for k in peaks:
            peaks[k] = max(peaks[k], r[k])
        del stored, view
        torch.cuda.empty_cache()
    n_items = sum(_qwen_items(cfg).values())
    common = {"bound_by": "bytes", "library_ms": None,
              "per": f"one Qwen2-7B encode ({n_items} launches)"}
    return ({"source": "src/repro_torch/csrc/quantize.cu",
             "replaces": "src/repro/kernels/quantize.py:33", "launches": counts["b3"],
             "ms": tot["b3_ms"], "plain_ms": tot["b3_plain_ms"], "bound_ms": tot["b3_bound_ms"],
             "bytes": tot["b3_bytes"], **common},
            {"source": "src/repro_torch/csrc/quantize_pack.cu",
             "replaces": "src/repro/kernels/quantize.py:33", "launches": counts["pack"],
             "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
             "bytes": tot["bytes"], "replaced_chain_ms": tot["chain_ms"], **peaks, **common},
            per_shape)


if __name__ == "__main__":
    sys.exit(main())
