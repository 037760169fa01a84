"""Figure 2 / Figure 13: bit-level inference scaling laws — port of
``benchmarks/fig2_bitlevel.py``.

Quantize each checkpoint of the trained tiny ladder at k in
{3,4,5,6,8,16} (float data type, block 64 — the paper's recommended
zero-shot configuration), evaluate held-out perplexity, fit
linear-interpolation scaling curves in log2(total model bits), and read
off the bit-level-optimal precision.  Paper claim: 4-bit optimal.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import QuantConfig
from repro_torch.core import scaling_laws as sl
from repro_torch.paper import common
from repro_torch.tree import leaves

PRECISIONS = [3, 4, 5, 6, 8, 16]


def run(family, log=print):
    """``family``: ``common.trained_family``'s {name: Trained}."""
    obs = []
    rows = []
    for name, t in family.items():
        cfg, params = t.cfg, t.params
        toks = common.eval_tokens(cfg, device=leaves(params)[0].device)
        for k in PRECISIONS:
            qcfg = None if k == 16 else QuantConfig(bits=k, dtype="float", block_size=64)
            ppl, bpp, total = common.evaluate_quant(cfg, params, qcfg, toks)
            obs.append(sl.Observation(
                n_params=cfg.param_count(), bits_per_param=bpp,
                metric=float(np.log(ppl)), precision=k,
                tags={"model": name}))
            rows.append((f"fig2/{name}/k{k}", 0.0,
                         f"ppl={ppl:.3f};bits={total/8e6:.3f}MB"))
            log(f"  {name} k={k:<2d} ppl={ppl:8.3f} total_bits={total:.3e}")
    curves = sl.fit_curves(obs)
    res = sl.optimal_precision(curves)
    rows.append(("fig2/optimal_precision", 0.0,
                 f"k={res['optimal_precision']};wins={res['wins']}"))
    log(f"fig2: bit-level optimal precision = {res['optimal_precision']} "
        f"(paper: 4) wins={res['wins']}")
    result = {
        "observations": [
            {"model": o.tags.get("model"), "precision": o.precision,
             "total_bits": o.total_bits, "log_ppl": o.metric}
            for o in obs
        ],
        "optimal_precision": res["optimal_precision"],
        "wins": res["wins"],
    }
    common.save_json("fig2_bitlevel", result)
    return rows, result
