#!/usr/bin/env python3
"""Where the continuous-batching Server's logits part from the per-request
Engine's, on one NVIDIA GPU.

Serves chip_smoke.py's server traffic (Qwen2-7B at full width and depth,
seeded random weights quantized to 4-bit float at block 64, a kv4 pool of 8
slots, 24 requests) keeping every decode step's logits, then teacher-forces
each request alone (batch 1) on the Server's tokens through the Engine's
decode step, twice: after a prefill at the prompt's exact length (what the
Engine does) and after one padded to the Server's bucket (what the Server
does).  Prints, for each, the largest and median per-step logit gap, the
share of steps with a gap above 0.08 or of exactly 0, and the margins of
the greedy tokens that differ.

Run from the repository root:  python3 scripts/server_engine_gap.py
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.serving.engine import capture_graph  # noqa: E402
from repro_torch.serving.server import bucket_len  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("server_engine_gap: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = get_arch(cs.ARCH).with_kv_quant(4)
    params = lm.init_params(cfg, seed=cs.SEED, device=dev, dtype=torch.bfloat16)
    q = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                        device=dev)
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
        for mode in ("exact", "bucket"):
            gaps, margins = [], []
            for r, rid in zip(reqs, ids):
                toks, rows = res[rid], srv.kept.get(rid, [])
                L = len(r["prompt"])
                prompt = torch.as_tensor(r["prompt"], device=dev)[None]
                if mode == "bucket":
                    padded = torch.zeros((1, bucket_len(L, cap=cache_len)), dtype=torch.int64,
                                         device=dev)
                    padded[0, :L] = prompt[0]
                    _, cc = lm.backbone_seq(q, padded, cfg, write_cache=True,
                                            cache_len=cache_len)
                    for c in cc:
                        c["pos"].masked_fill_(c["pos"] >= L, -1)
                else:
                    _, cc = lm.prefill(q, prompt, cfg, cache_len=cache_len)
                for mine, theirs in zip(caches, cc):
                    for key in mine:
                        mine[key].copy_(theirs[key])
                pos.fill_(L)
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
            print(f"{mode}: steps {g.numel()} max gap {float(g.max())} median "
                  f"{float(g.median())} share > 0.08 {float((g > 0.08).float().mean())} "
                  f"share exactly 0 {float((g == 0).float().mean())} differing greedy "
                  f"tokens {len(margins)} largest margins {sorted(margins)[-5:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
