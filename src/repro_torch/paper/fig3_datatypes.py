"""Figure 3 (left) / Figure 9 / Figure 14: quantization data types at
4-bit — port of ``benchmarks/fig3_datatypes.py``.

Paper claims: quantile best on perplexity; float > int generally; dynamic
exponent worst-ish.  Evaluated across the model ladder at fixed k=4.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import QuantConfig
from repro_torch.paper import common
from repro_torch.tree import leaves

DTYPES = ["int", "float", "dynamic", "quantile"]


def run(family, log=print, bits=4):
    """``family``: ``common.trained_family``'s {name: Trained}."""
    rows, summary = [], {dt: [] for dt in DTYPES}
    for name, t in family.items():
        cfg, params = t.cfg, t.params
        toks = common.eval_tokens(cfg, device=leaves(params)[0].device)
        base, _, _ = common.evaluate_quant(cfg, params, None, toks)
        for dt in DTYPES:
            ppl, bpp, total = common.evaluate_quant(
                cfg, params, QuantConfig(bits=bits, dtype=dt, block_size=64), toks
            )
            summary[dt].append(np.log(ppl) - np.log(base))
            rows.append((f"fig3dt/{name}/{dt}", 0.0,
                         f"ppl={ppl:.3f};degr={np.log(ppl)-np.log(base):.4f}"))
            log(f"  {name} {dt:9s} ppl={ppl:8.3f} (fp16 {base:.3f})")
    mean_degr = {dt: float(np.mean(v)) for dt, v in summary.items()}
    ranking = sorted(mean_degr, key=mean_degr.get)
    rows.append(("fig3dt/ranking", 0.0, ">".join(ranking)))
    log(f"fig3 data types (mean log-ppl degradation): {mean_degr}")
    log(f"  best -> worst: {ranking}  (paper: quantile best, dynamic/int worst)")
    common.save_json("fig3_datatypes", {"mean_degradation": mean_degr,
                                        "ranking": ranking})
    return rows, ranking
