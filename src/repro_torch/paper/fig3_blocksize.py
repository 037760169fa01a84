"""Figure 3 (right) / Figure 8 / Figure 15: block size at low precision —
port of ``benchmarks/fig3_blocksize.py``.

Paper claims: small blocks (64-128) improve 3-5 bit scaling (worth ~the
step from 4 to 5 bits for Pythia); negligible at 6-8 bit (App. C.3).
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import QuantConfig
from repro_torch.paper import common
from repro_torch.tree import leaves

BLOCKS = [32, 64, 128, 256, 1024]


def run(family, log=print):
    """``family``: ``common.trained_family``'s {name: Trained}."""
    rows = []
    effect = {}
    for bits in (4, 8):
        degr = {B: [] for B in BLOCKS}
        for name, t in family.items():
            cfg, params = t.cfg, t.params
            toks = common.eval_tokens(cfg, device=leaves(params)[0].device)
            base, _, _ = common.evaluate_quant(cfg, params, None, toks)
            for B in BLOCKS:
                ppl, bpp, total = common.evaluate_quant(
                    cfg, params,
                    QuantConfig(bits=bits, dtype="float", block_size=B), toks)
                degr[B].append(np.log(ppl) - np.log(base))
                rows.append((f"fig3bs/{name}/k{bits}/b{B}", 0.0,
                             f"ppl={ppl:.3f};bits_pp={bpp:.3f}"))
        mean = {B: float(np.mean(v)) for B, v in degr.items()}
        effect[bits] = mean
        log(f"fig3 block size @ {bits}-bit mean log-ppl degradation: {mean}")
    # paper: at 4-bit small blocks help; at 8-bit the effect vanishes
    gain4 = effect[4][1024] - effect[4][64]
    gain8 = effect[8][1024] - effect[8][64]
    rows.append(("fig3bs/gain_small_block_4bit", 0.0, f"{gain4:.4f}"))
    rows.append(("fig3bs/gain_small_block_8bit", 0.0, f"{gain8:.4f}"))
    log(f"  small-block gain: 4-bit {gain4:.4f} vs 8-bit {gain8:.4f} "
        f"(paper: large vs ~none)")
    common.save_json("fig3_blocksize", effect)
    return rows, effect
