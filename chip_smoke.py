#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:
  1. build   — compile every CUDA source of the port (one nvcc each, in
               parallel) into build/kernels/.
  2. kernels — hold each kernel against its plain PyTorch version on the card:
               the fused dequant-GEMM (f32 activations: relative error
               <= 2e-5, f32 summation order; bf16: <= 2^-7 * max|y|, one
               bf16 ulp at the max) and the KV dequant (bit-exact).
  3. serve   — Qwen2-7B at full width and depth, seeded random weights
               quantized on the card (4-bit float, block 64), Engine with a
               kv4 cache: 4 prompts x 256 tokens, 32 greedy tokens.  Checks
               finite logits and the kernel launches per decode step.
  4. modes   — teacher-forced logits, fused kernel vs dequant_einsum.
  5. kv_tol  — kv_oracle_logit_gap on tiny-650k, kernels in the loop.
  6. times   — each kernel at the main path's shapes beside its plain
               version, its bound and a PyTorch library call, each timed
               as device time: captured in a CUDA graph and replayed.
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
    report = _build.build(["qmatmul", "kv_dequant"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in report.items()}})

    errs = check_kernels(torch, dev)
    run = serve_main_path(torch, dev)
    mode_gap = mode_parity(torch, dev, run)
    kv_gaps = kv_tolerance(torch, dev)
    times = time_kernels(torch, dev, run)
    del run

    kernels = []
    for name, err_key in (("qmatmul_gemv", "gemv"), ("qmatmul_gemm", "gemm"),
                          ("kv_dequant", "kv")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": t["source"], "replaces": t["replaces"],
            "launches": t["launches"], "max_abs_err": errs[err_key],
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
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk

    g = _gen(torch, dev, SEED + 1)
    worst = {"gemv": 0.0, "gemm": 0.0, "kv": 0.0}
    n_checks = 0

    def check_b1(M, K, N, bits, dtype, block, xdt, main_path):
        nonlocal n_checks
        w = torch.randn((K, N), generator=g, device=dev) * 0.05
        op = ops.prepare_operand(w, bits=bits, dtype=dtype, block_size=block)
        x = torch.randn((M, K), generator=g, device=dev).to(xdt)
        xp, packed, scales = ops.pad_for_kernel(x, op)
        kw = dict(bits=bits, block_size=block)
        y_k = qk.qmatmul_cuda(xp, packed, scales, op.codebook, **kw).float()
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

    # odd word tails and scale blocks that words straddle; the GEMV at 1, 2,
    # 4 and 8 rows (3 and 5 mask rows), the tiled kernels past 8 rows
    for bits in (3, 4, 5, 6, 8):
        for dtype in ("int", "float", "dynamic"):
            for xdt in (torch.float32, torch.bfloat16):
                for block in (16, 32):
                    for M in (1, 2, 3, 5, 37):
                        check_b1(M, 200, 70, bits, dtype, block, xdt, False)
    cfg = get_arch(ARCH)
    D, F, KD, V = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim, cfg.vocab_size
    shapes = [(D, D), (D, KD), (D, F), (F, D), (D, V)]
    for K, N in shapes:
        for M in (BATCH, BATCH * PROMPT):
            check_b1(M, K, N, 4, "float", 64, torch.bfloat16, True)
        check_b1(BATCH, K, N, 4, "float", 64, torch.float32, False)

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
    emit({"phase": "kernels", "checks": n_checks, "max_abs_err_main_shapes": worst,
          "tolerance": {"f32_rel": F32_REL_TOL, "bf16_rel_to_max": BF16_REL_TOL,
                        "kv_dequant": "bit-exact"}})
    return worst


def _counts():
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import qmatmul as qk

    return {"gemv": qk.qmatmul_gemv.launches, "gemm": qk.qmatmul_gemm.launches,
            "kv": kvd.dequant_rows_cuda.launches}


def _reset_counts():
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import qmatmul as qk

    qk.qmatmul_gemv.launches = 0
    qk.qmatmul_gemm.launches = 0
    kvd.dequant_rows_cuda.launches = 0


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
    t1 = time.perf_counter()
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64),
                              cfg, device=dev)
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
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
    per_layer = 7   # wq, wk, wv, wo, w_gate, w_up, w_down
    b1_step = per_layer * cfg.n_layers + 1
    b2_step = 2 * cfg.n_layers
    require(tuple(tokens.shape) == (BATCH, NEW_TOKENS), f"tokens shape {tuple(tokens.shape)}")
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens out of range")
    require(counts["gemm"] == per_layer * cfg.n_layers,
            f"prefill: {counts['gemm']} tiled qmatmul launches")
    require(counts["gemv"] == 1 + n_steps * b1_step,
            f"{counts['gemv']} GEMV launches, want 1 + {n_steps} x {b1_step}")
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
    require(step_counts == {"gemv": b1_step, "gemm": 0, "kv": b2_step},
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
          "launches": counts, "launches_per_decode_step": step_counts})
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
    """Phase 6: the kernels at the main path's shapes, one decode step's and
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
    src_b1, rep_b1 = "src/repro_torch/csrc/qmatmul.cu", "src/repro/kernels/qmatmul.py:97"
    for name, M, with_head, fn, reps in (
            ("qmatmul_gemv", BATCH, True, qk.qmatmul_gemv, 10),
            ("qmatmul_gemm", BATCH * PROMPT, False, qk.qmatmul_gemm, 3)):
        calls, nbytes, flops = plan(M, with_head)
        ms = _time_ms(torch, b1(calls, fn), reps)
        plain_ms = _time_ms(torch, b1(calls, qk.qmatmul_plain), 2)
        dense = [dequantize_tensor(op_qt, out_dtype=torch.bfloat16)
                 for op_qt in (qts + ([qparams["lm_head"]] if with_head else []))]

        def lib():
            for (_, _, _, _, x), w in zip(calls, dense):
                torch.matmul(x, w.T)
        library_ms = _time_ms(torch, lib, reps)
        del dense
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = {"source": src_b1, "replaces": rep_b1,
                     "launches": counts["gemv" if name == "qmatmul_gemv" else "gemm"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "per": "decode step (197 launches)" if with_head
                     else "prefill (196 launches)", "M": M, "bytes": nbytes, "flops": flops}
        per_shape = shapes_ms.setdefault(f"{name}_M{M}", {})
        for K, N in sorted({(c[3].k_dim, c[1].shape[0]) for c in calls}):
            sub = [c for c in calls if c[3].k_dim == K and c[1].shape[0] == N]
            sub_ms = _time_ms(torch, b1(sub, fn), reps) / len(sub)
            sb = sub[0][1].numel() * 4 + sub[0][2].numel() * 2 + M * K * 2 + M * N * 2
            per_shape[f"{K}x{N}"] = {"ms_per_call": sub_ms,
                                     "bound_ms_per_call": _bound(sb, 2.0 * M * N * K)[0]}
        del calls

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
    emit({"phase": "times", "card_rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                                           "bf16_flop_per_s": BF16_FLOP_PER_S},
          "kernels": out, "per_shape": shapes_ms,
          "library_note": {"qmatmul": "torch.matmul on the pre-dequantized bf16 weight",
                           "kv_dequant": "no single PyTorch call computes it"}})
    return out


if __name__ == "__main__":
    sys.exit(main())
