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
               (bit-exact) and the blockwise encode (bit-exact codes and
               scale bits).
  3. serve   — Qwen2-7B at full width and depth, seeded random weights
               quantized on the card through the encode kernel (4-bit
               float, block 64; one launch per quantized matrix), Engine
               with a kv4 cache: 4 prompts x 256 tokens, 32 greedy tokens.
               Checks finite logits and the kernel launches per decode step
               (every GEMV on the tensor cores, qgemv_sm90).
  4. modes   — teacher-forced logits, fused kernel vs dequant_einsum.
  5. kv_tol  — kv_oracle_logit_gap on tiny-650k, kernels in the loop.
  6. paper   — the paper's bit-level sweep: trains the tiny ladder on the
               card (paper.common.TRAIN_RECIPE), encodes every checkpoint
               through the encode kernel and reads perplexity through the
               fused GEMM (fig2: k in {3,4,5,6,8,16}; fig3 data types and
               block sizes); gates training progress and 8-bit perplexity.
  7. times   — each kernel at the main path's shapes beside its plain
               version, its bound and a PyTorch library call, each timed
               as device time: captured in a CUDA graph and replayed; B1
               also per shape, beside torch.matmul per shape, and the
               decode GEMV beside the CUDA-core GEMV on the same operands.
Then the kernels line, the card's name and power limit, and the result.
Needs no network, imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "qwen2-7b"
BATCH, PROMPT, NEW_TOKENS, KV_BITS = 4, 256, 32, 4
# H100 SXM data-sheet rates: HBM bytes/s and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_REL_TOL = 2e-5          # tests/test_qmatmul_parity.py REL_TOL: f32 summation order
BF16_REL_TOL = 2.0 ** -7    # one bf16 ulp at max|y|
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
    report = _build.build(["qgemv_sm90", "qmatmul", "qgemm_sm90", "kv_dequant", "quantize"])
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
    for name, key in (("qmatmul_gemv", "gemv"), ("qmatmul_gemm", "gemm"),
                      ("kv_dequant", "kv"), ("quantize_blocks", "b3")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": t["source"], "replaces": t["replaces"],
            # the main paths' launches: serving Qwen2-7B (its quantization
            # included) and the paper's sweep
            "launches": t["launches"] + paper["launches"][key],
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
    worst = {"gemv": 0.0, "gemm": 0.0, "kv": 0.0, "b3": 0.0}
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
    emit({"phase": "kernels", "checks": n_checks, "max_abs_err_main_shapes": worst,
          "tolerance": {"f32_rel": F32_REL_TOL, "bf16_rel_to_max": BF16_REL_TOL,
                        "kv_dequant": "bit-exact", "quantize_blocks": "bit-exact"}})
    return worst


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

    from repro_torch.kernels import quantize as quantk

    return {"gemv": qk.qmatmul_gemv.launches, "gemv_tc": qk.qmatmul_gemv_tc.launches,
            "gemm": qk.qmatmul_gemm.launches, "kv": kvd.dequant_rows_cuda.launches,
            "b3": quantk.quantize_blocks_cuda.launches}


def _reset_counts():
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels import quantize as quantk

    qk.qmatmul_gemv.launches = 0
    qk.qmatmul_gemv_tc.launches = 0
    qk.qmatmul_gemv_simt.launches = 0
    qk.qmatmul_gemm.launches = 0
    kvd.dequant_rows_cuda.launches = 0
    quantk.quantize_blocks_cuda.launches = 0


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
    t1 = time.perf_counter()
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64),
                              cfg, device=dev)
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    per_layer = 7   # wq, wk, wv, wo, w_gate, w_up, w_down
    quant_counts = _counts()
    n_items = per_layer * cfg.n_layers + (0 if cfg.tie_embeddings else 1)   # + lm_head
    require(quant_counts == {"gemv": 0, "gemv_tc": 0, "gemm": 0, "kv": 0, "b3": n_items},
            f"quantize_params launched {quant_counts}, want {n_items} encode launches")
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
    peak_bytes = torch.cuda.max_memory_allocated()
    n_steps = NEW_TOKENS - 1
    b1_step = per_layer * cfg.n_layers + 1
    b2_step = 2 * cfg.n_layers
    require(tuple(tokens.shape) == (BATCH, NEW_TOKENS), f"tokens shape {tuple(tokens.shape)}")
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens out of range")
    require(counts["gemm"] == per_layer * cfg.n_layers,
            f"prefill: {counts['gemm']} tiled qmatmul launches")
    require(counts["gemv"] == 1 + n_steps * b1_step,
            f"{counts['gemv']} GEMV launches, want 1 + {n_steps} x {b1_step}")
    require(counts["gemv_tc"] == counts["gemv"],
            f"{counts['gemv_tc']} of {counts['gemv']} GEMV launches on the tensor cores")
    require(counts["kv"] == n_steps * b2_step,
            f"{counts['kv']} kv dequant launches, want {n_steps} x {b2_step}")

    # one more prefill and decode step with logits in hand
    logits, caches = lm.prefill(qparams, prompts, cfg, cache_len=PROMPT + NEW_TOKENS)
    _reset_counts()
    step_logits, _ = lm.decode_step(qparams, tokens[:, 0], caches, PROMPT, cfg)
    torch.cuda.synchronize()
    step_counts = _counts()
    require(bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all()),
            "non-finite logits")
    require(step_counts == {"gemv": b1_step, "gemv_tc": b1_step, "gemm": 0, "kv": b2_step,
                            "b3": 0},
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
          "launches": counts, "launches_per_decode_step": step_counts,
          "launches_quantize": quant_counts})
    require(counts["b3"] == 0, f"generate launched {counts['b3']} encodes")
    counts["b3"] = quant_counts["b3"]
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
        before = _counts()["kv"]
        gap, agree = kv_oracle_logit_gap(params, cfg.with_kv_quant(bits), prompts, 8, device=dev)
        require(_counts()["kv"] > before, "kv dequant kernel not in the loop")
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
    require(counts["b3"] > 0 and counts["gemm"] > 0,
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


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
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
                     "launches": counts["gemv" if name == "qmatmul_gemv" else "gemm"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "cuda_core_gemv_ms": old_ms,
                     "per": "decode step (197 launches)" if with_head
                     else "prefill (196 launches)", "M": M, "bytes": nbytes, "flops": flops}
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
        "per": "decode step (56 launches)", "bytes": kv_bytes}
    out["quantize_blocks"], shapes_ms["quantize_blocks_B64"] = _time_encode(
        torch, dev, cfg, counts["b3"], g)
    emit({"phase": "times", "card_rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                                           "bf16_flop_per_s": BF16_FLOP_PER_S},
          "kernels": out, "per_shape": shapes_ms,
          "library_note": {"qmatmul": "torch.matmul on the pre-dequantized bf16 weight",
                           "kv_dequant": "no single PyTorch call computes it",
                           "quantize_blocks": "no single PyTorch call computes it"}})
    return out


def _time_encode(torch, dev, cfg, launches, g):
    """The encode kernel at each Qwen2-7B item shape (4-bit float, block
    64), per launch and summed over one whole-model encode (one launch per
    quantized matrix: 7 per layer and the lm_head)."""
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import quantize as quantk

    cb = make_codebook("float", 4, device=dev)
    per_model = _qwen_items(cfg)
    per_shape = {}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0}
    for (rows, cols), n in per_model.items():
        xb = torch.randn((rows, cols), generator=g, device=dev).to(torch.bfloat16)
        xb = xb.reshape(-1).float().reshape(-1, 64)
        ms = _time_ms(torch, lambda: quantk.quantize_blocks_cuda(xb, cb), 10)
        plain_ms = _time_ms(torch, lambda: quantk.quantize_blocks_plain(xb, cb), 3)
        # its contract's bytes: 4 in and 4 of code per value, 4 of scale per block
        nbytes = xb.numel() * 8 + xb.shape[0] * 4 + cb.numel() * 4
        bound_ms = _bound(nbytes, 0.0)[0]
        per_shape[f"{rows}x{cols}"] = {"ms_per_call": ms, "plain_ms_per_call": plain_ms,
                                       "bound_ms_per_call": bound_ms, "per_model_encode": n}
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                       ("bytes", nbytes)):
            tot[key] += n * v
        del xb
        torch.cuda.empty_cache()
    return ({"source": "src/repro_torch/csrc/quantize.cu",
             "replaces": "src/repro/kernels/quantize.py:33", "launches": launches,
             "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
             "bound_by": "bytes", "library_ms": None,
             "per": f"one Qwen2-7B encode ({sum(per_model.values())} launches)",
             "bytes": tot["bytes"]}, per_shape)


if __name__ == "__main__":
    sys.exit(main())
