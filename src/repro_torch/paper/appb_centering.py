"""Appendix B: distribution centering, the paper's documented NEGATIVE
result — port of ``benchmarks/appb_centering.py``.

Centering pays twice the scale bits (a mean and an absmax a block) and does
not improve weight-quantization scaling.  We reproduce the non-effect.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import QuantConfig
from repro_torch.paper import common
from repro_torch.tree import leaves

BITS = (4, 8)


def run(family, log=print):
    """``family``: ``common.trained_family``'s {name: Trained}.  Returns the
    rows and {"mean_delta": mean log-ppl change, "models": {model: {bits:
    {"plain", "centered": (perplexity, bits per parameter)}}}}."""
    rows, deltas, models = [], [], {}
    for name, t in family.items():
        cfg, params = t.cfg, t.params
        toks = common.eval_tokens(cfg, device=leaves(params)[0].device)
        models[name] = {}
        for bits in BITS:
            p0, b0, _ = common.evaluate_quant(cfg, params, QuantConfig(bits=bits, dtype="int"),
                                              toks)
            p1, b1, _ = common.evaluate_quant(
                cfg, params, QuantConfig(bits=bits, dtype="int", centering=True), toks)
            deltas.append(np.log(p1) - np.log(p0))
            models[name][bits] = {"plain": (p0, b0), "centered": (p1, b1)}
            rows.append((f"appb/{name}/k{bits}", 0.0,
                         f"plain={p0:.3f}@{b0:.2f}bpp;centered={p1:.3f}@{b1:.2f}bpp"))
            log(f"  {name} k={bits} plain {p0:.3f} ({b0:.2f}bpp) "
                f"centered {p1:.3f} ({b1:.2f}bpp)")
    mean_delta = float(np.mean(deltas))
    rows.append(("appb/mean_logppl_delta", 0.0, f"{mean_delta:+.5f}"))
    log(f"appB centering: mean log-ppl delta {mean_delta:+.5f} at +16/B bits "
        f"cost (paper: no improvement -> expect >= ~0)")
    result = {"mean_delta": mean_delta, "models": models}
    common.save_json("appb_centering", result)
    return rows, result
