#!/usr/bin/env python3
"""The Qwen2-7B decode step's device time, again and again in one process,
with the card's clocks beside each reading, on one NVIDIA GPU.

Quantizes Qwen2-7B (seeded random weights, 4-bit float at block 64, kv4),
prefills 4 x 256 tokens, then times one eager ``lm.decode_step`` twelve
times as chip_smoke.py times it (captured in a CUDA graph, the median of 5
replays by CUDA events; a new graph each time), printing each time with
the card's SM and memory clocks, power, temperature and throttle reasons.
A tree whose decode step takes a device tensor position is also timed with
one.  The tree is the one named on the command line (default: this one),
so two commits can be compared in one call.

Run from the repository root:  python3 scripts/step_device_time.py [TREE]
"""

import subprocess
import sys
from pathlib import Path

TREE = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(TREE / "src"))
sys.path.insert(0, str(TREE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("step_device_time: needs a CUDA device", file=sys.stderr)
        return 2
    _build.build(["qgemv_sm90", "qmatmul", "qgemm_sm90", "kv_dequant", "quantize",
                  "quantize_pack", "kv_decode_attention"])
    dev = torch.device("cuda")
    cfg = get_arch(cs.ARCH).with_kv_quant(cs.KV_BITS)
    params = lm.init_params(cfg, seed=cs.SEED, device=dev, dtype=torch.bfloat16)
    q = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                        device=dev)
    del params
    prompts = torch.randint(0, cfg.vocab_size, (cs.BATCH, cs.PROMPT), device=dev,
                            generator=cs._gen(torch, dev, cs.SEED + 2))
    cache_len = cs.PROMPT + cs.NEW_TOKENS
    with torch.inference_mode():
        logits, caches = lm.prefill(q, prompts, cfg, cache_len=cache_len)
        tok = torch.argmax(logits, -1).to(torch.int32)
        variants = [("int", cs.PROMPT)]
        if hasattr(attention, "as_position"):
            variants.append(("tensor", torch.full((), cs.PROMPT, dtype=torch.int32,
                                                  device=dev)))
        for i in range(12 // len(variants)):
            for name, pos in variants:
                ms = cs._time_ms(torch, lambda: lm.decode_step(q, tok, caches, pos, cfg), 5)
                print(f"{TREE.name} {i} {name} {ms:.3f} ms | {clocks()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
