#!/usr/bin/env python3
"""Where a sliding-window decode's logit gaps come from, on one NVIDIA GPU.

h2o-danube-3-4b at full width and depth (seeded bf16 weights quantized on
the card, 4-bit float, block 64), teacher-forced decode steps against
``lm.backbone_seq``'s logits at the same positions (kv16, dequant_einsum,
as chip_smoke's ring gate):

* ``ring``: a 4160-token prompt (the prefill wraps every 4096-slot ring),
  63 steps past the window;
* ``linear``: the same steps over the same K/V unrolled into linear caches
  (no slot reused, the window masking alone);
* ``short``: a 2048-token prompt whose steps never reach the window.

Then batch invariance of the routed read: one kv4 decode step over 4 rows
against each row alone, with the partials a row at a time (the port) and
batched (``attention._partials`` over all rows at once); and the decode
step's device time both ways (danube at 2 rows and 4096 slots, tiny-10m at
4 rows and 96 slots).

    python3 scripts/window_gaps.py            # ~2 min with the build
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402


def _q4(cfg, dev):
    params = lm.init_params(cfg, seed=cs.SEED, device=dev, dtype=torch.bfloat16)
    q = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                        device=dev)
    del params
    torch.cuda.empty_cache()
    return q


def _gaps(q, cfg, seq, prompt_len, total, linear=False):
    """Max |decode - full forward| over the steps from prompt_len - 1."""
    h, _ = lm.backbone_seq(q, seq[:, :total], cfg)
    full = lm.logits_from_hidden(q, h[:, prompt_len - 1:total - 1], cfg).float()
    del h
    logits, caches = lm.prefill(q, seq[:, :prompt_len], cfg, cache_len=total)
    if linear:
        caches = cs._unrolled(torch, caches, total)
    out = [logits.float()]
    for t in range(prompt_len, total - 1):
        logits, caches = lm.decode_step(q, seq[:, t], caches, t, cfg)
        out.append(logits.float())
    out = torch.stack(out, 1)
    return float((out - full).abs().max()), out


def _batch_gap(q, cfg, dev, S):
    """One decode step over 4 rows against each row alone: max logit gap."""
    B = 4
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=cs._gen(torch, dev, 5),
                            device=dev)
    _, caches = lm.prefill(q, prompts, cfg, cache_len=S + 8)
    tok = prompts[:, -1]
    rows = [tuple({k: v.clone() if k == "pos" else v[:, b:b + 1].clone()
                   for k, v in c.items()} for c in caches) for b in range(B)]
    together, _ = lm.decode_step(q, tok, caches, S, cfg)
    gap = 0.0
    for b, one in enumerate(rows):
        alone, _ = lm.decode_step(q, tok[b:b + 1], one, S, cfg)
        gap = max(gap, float((alone.float() - together[b:b + 1].float()).abs().max()))
    return gap


def _step_ms(q, cfg, dev, B, S):
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=cs._gen(torch, dev, 6),
                            device=dev)
    _, caches = lm.prefill(q, prompts, cfg, cache_len=S + 8)
    tok = prompts[:, -1].contiguous()
    pos = torch.full((), S, dtype=torch.int32, device=dev)
    return cs._time_ms(torch, lambda: lm.decode_step(q, tok, caches, pos, cfg), 10)


def main() -> int:
    if not torch.cuda.is_available():
        print("window_gaps: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["qgemv_sm90", "qgemm_sm90", "kv_dequant", "quantize_pack",
                  "kv_decode_attention"])
    dev = torch.device("cuda")
    base = get_arch("h2o-danube-3-4b")
    out = {"arch": base.name}
    with torch.inference_mode():
        q = _q4(base, dev)
        cfg = base.with_kv_quant(16).with_matmul_mode("dequant_einsum")
        seq = torch.randint(0, base.vocab_size, (2, cs.WIN_CACHE),
                            generator=cs._gen(torch, dev, cs.SEED + 12), device=dev)
        ring, ring_out = _gaps(q, cfg, seq, cs.WIN_PROMPT, cs.WIN_CACHE)
        lin, lin_out = _gaps(q, cfg, seq, cs.WIN_PROMPT, cs.WIN_CACHE, linear=True)
        short, _ = _gaps(q, cfg, seq, 2048, 2048 + cs.WIN_CACHE - cs.WIN_PROMPT)
        out["vs_full_forward"] = {"ring": ring, "linear": lin, "short_no_window": short,
                                  "ring_vs_linear": float((ring_out - lin_out).abs().max())}
        del ring_out, lin_out
        kv4 = base.with_kv_quant(4)
        per_row = attention.decode_attention_partial
        for name, fn in (("row_at_a_time", per_row), ("batched", attention._partials)):
            attention.decode_attention_partial = fn
            try:
                out[name] = {"batch4_vs_alone_logit_gap": _batch_gap(q, kv4, dev, 4100),
                             "danube_step_ms_B2_4096": _step_ms(q, kv4, dev, 2, 4160)}
            finally:
                attention.decode_attention_partial = per_row
        del q
        torch.cuda.empty_cache()
        tiny = get_arch("tiny-10m").with_kv_quant(4)
        qt = _q4(tiny, dev)
        for name, fn in (("row_at_a_time", per_row), ("batched", attention._partials)):
            attention.decode_attention_partial = fn
            try:
                out[name]["tiny10m_step_ms_B4_96"] = _step_ms(qt, tiny, dev, 4, 88)
            finally:
                attention.decode_attention_partial = per_row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
