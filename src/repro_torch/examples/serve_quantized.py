"""End-to-end serving driver (the paper's deployment story) — port of the
reference's ``examples/serve_quantized.py``: train a small LM, quantize it
per the paper's recommendation (4-bit float, block 64) and other ways, and
serve batched generation through the Engine, comparing quality and model
bytes against the 16-bit baseline.

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import QuantConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models.quantize import bits_report, quantize_params
from repro_torch.serving import Engine, perplexity
from repro_torch.serving.engine import fence
from repro_torch.train import loop
from repro_torch.tree import leaves

CONFIGS = [
    ("fp16 baseline", None),
    ("4-bit float b64 (paper rec.)", QuantConfig(bits=4, dtype="float", block_size=64)),
    ("4-bit quantile b64", QuantConfig(bits=4, dtype="quantile", block_size=64)),
    ("3-bit int b1024", QuantConfig(bits=3, dtype="int", block_size=1024)),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-650k")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.2f}M params)…")
    state, _ = loop.train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                          log_every=50, device=dev)

    proc = synthetic.ZipfMarkov(cfg.vocab_size, device=dev)
    eval_toks = proc.sample(synthetic.generator(9, dev), 16, 129)
    prompts = proc.sample(synthetic.generator(10, dev), 8, 32)
    results = {}
    for label, qcfg in CONFIGS:
        params = state.params if qcfg is None else quantize_params(state.params, qcfg, cfg,
                                                                   device=dev)
        ppl = perplexity(params, cfg, eval_toks, device=dev)
        if qcfg is None:
            nbytes = sum(x.numel() * 2 for x in leaves(params))
        else:
            nbytes = bits_report(params)["total_bits_ideal"] / 8
        engine = Engine(params, cfg, max_seq_len=prompts.shape[1] + args.max_new, device=dev)
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.max_new)
        fence(out)
        dt = time.perf_counter() - t0
        results[label] = {"ppl": ppl, "model_bytes": nbytes, "tokens_per_s": out.numel() / dt}
        print(f"{label:32s} ppl={ppl:8.3f} model={nbytes/1e6:7.2f}MB "
              f"gen={out.numel()/dt:7.1f} tok/s")
    print("\nsample continuation (3-bit):", out[0, :16].tolist())
    return results


if __name__ == "__main__":
    main()
