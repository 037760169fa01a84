"""Figure 4: outlier-dependent (proxy) quantization — port of
``benchmarks/fig4_proxy.py``.

Paper claims: proxy quantization (the top-2% producer-std dims in 16-bit)
stabilizes or improves 3-bit, has no benefit at 4-bit, and even improved
3-bit still loses to plain 4-bit at the bit level.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import QuantConfig
from repro_torch.paper import common
from repro_torch.tree import leaves

CONFIGS = {
    "3bit": QuantConfig(bits=3, dtype="float", block_size=64),
    "3bit+proxy2%": QuantConfig(bits=3, dtype="float", block_size=64, outlier_pct=0.02),
    "4bit": QuantConfig(bits=4, dtype="float", block_size=64),
    "4bit+proxy2%": QuantConfig(bits=4, dtype="float", block_size=64, outlier_pct=0.02),
}


def run(family, log=print):
    """``family``: ``common.trained_family``'s {name: Trained}.  Returns the
    rows and {"ppl": {model: {label: perplexity}}, "bits": {model: {label:
    bits per parameter}}, "proxy_helps_3bit_frac", "proxy3bit_beats_4bit_frac"}."""
    rows = []
    agg, bits = {}, {}
    for name, t in family.items():
        cfg, params = t.cfg, t.params
        toks = common.eval_tokens(cfg, device=leaves(params)[0].device)
        agg[name], bits[name] = {}, {}
        for label, qcfg in CONFIGS.items():
            ppl, bpp, total = common.evaluate_quant(cfg, params, qcfg, toks)
            agg[name][label], bits[name][label] = ppl, bpp
            rows.append((f"fig4/{name}/{label}", 0.0, f"ppl={ppl:.3f};bits={total:.3e}"))
            log(f"  {name} {label:13s} ppl={ppl:8.3f}")
    helps_3bit = float(np.mean([a["3bit+proxy2%"] <= a["3bit"] * 1.001 for a in agg.values()]))
    beats_4bit = float(np.mean([a["3bit+proxy2%"] < a["4bit"] for a in agg.values()]))
    rows.append(("fig4/proxy_helps_3bit_frac", 0.0, f"{helps_3bit:.2f}"))
    rows.append(("fig4/proxy3bit_beats_4bit_frac", 0.0, f"{beats_4bit:.2f}"))
    log(f"fig4: proxy helps 3-bit on {helps_3bit:.0%} of models; "
        f"3-bit+proxy beats 4-bit on {beats_4bit:.0%} (paper: ~100% / 0%)")
    result = {"ppl": agg, "bits": bits, "proxy_helps_3bit_frac": helps_3bit,
              "proxy3bit_beats_4bit_frac": beats_4bit}
    common.save_json("fig4_proxy", result)
    return rows, result
