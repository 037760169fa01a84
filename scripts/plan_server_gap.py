#!/usr/bin/env python3
"""Where the continuous-batching Server's logits part from the per-request
Engine's under a mixed-precision plan with a dense unit, on one NVIDIA GPU.

Quantizes chip_smoke.py's seeded Qwen2-7B (full width and depth) with its
fixed plan (FIXED_PLAN_BITS: every width from 3 to 8 bits and a dense
16-bit ``wk``) or at uniform 4 bits, serves chip_smoke.py's server traffic
(a kv4 pool of 8 slots, 24 requests) keeping every decode step's logits,
then teacher-forces each request alone (batch 1) on the Server's tokens
through the Engine's decode step after a prefill at the prompt's exact
length (as chip_smoke.py's plan phase does).  Prints the largest and
median per-step logit gap, the share of steps with a gap above 0.08 or of
exactly 0, and the margins of the greedy tokens that differ.

``--dense single`` sends every dense product (the 16-bit unit) through one
cuBLAS call of the whole batch, as the port did before
``layers.matmul_rounded`` took fixed-shape row pieces on the card.

Run from the repository root:
    python3 scripts/plan_server_gap.py [--plan fixed|uniform4] [--dense pieces|single]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.quantize import quantize_params, quantize_tree  # noqa: E402
from repro_torch.serving.engine import capture_graph  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", choices=["fixed", "uniform4"], default="fixed")
    ap.add_argument("--dense", choices=["pieces", "single"], default="pieces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plan_server_gap: needs a CUDA device", file=sys.stderr)
        return 2
    if args.dense == "single":
        layers._row_pieces = lambda x: (x, x.shape[0])   # one call of every row
    dev = torch.device("cuda")
    cfg = get_arch(cs.ARCH).with_kv_quant(4)
    base = QuantConfig(bits=4, dtype="float", block_size=64)
    params = lm.init_params(cfg, seed=cs.SEED, device=dev, dtype=torch.bfloat16)
    if args.plan == "fixed":
        q = quantize_tree(params, cfg, plan=cs._fixed_plan(cfg, base), device=dev)
    else:
        q = quantize_params(params, base, cfg, device=dev)
    del params
    reqs = cs._server_requests(cfg)
    cache_len = cs.SERVER_PROMPT_LENS[1] + cs.SERVER_NEW_TOKENS[1]
    with torch.inference_mode():
        srv = cs._checked_server(torch)(q, cfg, num_slots=cs.SERVER_SLOTS,
                                        max_seq_len=cache_len, device=dev)
        ids = [srv.submit(r["prompt"], r["max_new"], arrival_time=r["arrival_time"])
               for r in reqs]
        res = srv.run_until_drained()
        caches = lm.init_caches(cfg, 1, cache_len, device=dev)
        tok = torch.zeros((1,), dtype=torch.int32, device=dev)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        box = {}

        def body():
            logits, _ = lm.decode_step(q, tok, caches, pos, cfg)
            if "out" not in box:
                box["out"] = torch.empty_like(logits)
            box["out"].copy_(logits)
            pos.add_(1)

        graph = capture_graph(body, dev)
        gaps, first, margins = [], [], []
        for r, rid in zip(reqs, ids):
            toks, rows = res[rid], srv.kept.get(rid, [])
            prompt = torch.as_tensor(r["prompt"], device=dev)[None]
            logits, cc = lm.prefill(q, prompt, cfg, cache_len=cache_len)
            first.append(float(logits[0].float().max() - logits[0].float()[toks[0]]))
            for mine, theirs in zip(caches, cc):
                for key in mine:
                    mine[key].copy_(theirs[key])
            pos.fill_(prompt.shape[1])
            eng = []
            for t in toks[:-1]:
                tok.fill_(t)
                graph.replay()
                eng.append(box["out"][0].float())
            if not eng:
                continue
            eng = torch.stack(eng)
            gaps.append((eng - torch.stack(rows).float()).abs().amax(-1))
            nxt = torch.tensor(toks[1:], device=dev)
            arg = eng.argmax(-1)
            idx = torch.arange(len(nxt), device=dev)
            margins += (eng[idx, arg] - eng[idx, nxt])[arg != nxt].tolist()
        g = torch.cat(gaps)
        print(f"plan {args.plan}, dense products {args.dense}: steps {g.numel()} max gap "
              f"{float(g.max())} median {float(g.median())} share > 0.08 "
              f"{float((g > 0.08).float().mean())} share exactly 0 "
              f"{float((g == 0).float().mean())} differing greedy tokens {len(margins)} "
              f"largest margins {sorted(margins)[-5:]} first-token margins above 0: "
              f"{[m for m in first if m > 0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
