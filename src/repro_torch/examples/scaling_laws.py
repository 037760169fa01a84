"""A miniature bit-level inference scaling law (the paper's Fig. 2) from
scratch — port of the reference's ``examples/scaling_laws.py``: train two
tiny LMs, quantize each at several precisions, fit the linear-interpolation
curves and report the bit-level-optimal precision.

    PYTHONPATH=src python -m repro_torch.examples.scaling_laws [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import QuantConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import scaling_laws as sl
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models.quantize import bits_report, quantize_params
from repro_torch.serving import perplexity
from repro_torch.train import loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="tiny-160k,tiny-650k")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    obs = []
    for name in args.sizes.split(","):
        cfg = get_arch(name)
        print(f"training {name}…")
        state, _ = loop.train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                              log=lambda *_: None, device=dev)
        toks = synthetic.ZipfMarkov(cfg.vocab_size, device=dev).sample(
            synthetic.generator(5, dev), 16, 129)
        for k in (3, 4, 8, 16):
            if k == 16:
                ppl = perplexity(state.params, cfg, toks, device=dev)
                bpp = 16.0
            else:
                qp = quantize_params(state.params, QuantConfig(bits=k, dtype="float"), cfg,
                                     device=dev)
                ppl = perplexity(qp, cfg, toks, device=dev)
                bpp = bits_report(qp)["avg_bits_per_param"]
            obs.append(sl.Observation(n_params=cfg.param_count(), bits_per_param=bpp,
                                      metric=float(np.log(ppl)), precision=k))
            print(f"  k={k:2d}: ppl {ppl:8.3f}  total bits {obs[-1].total_bits:.3e}")

    curves = sl.fit_curves(obs)
    res = sl.optimal_precision(curves)
    print("\nwins per precision across bit budgets:", res["wins"])
    print(f"bit-level optimal precision: {res['optimal_precision']} "
          "(paper: 4-bit almost universally optimal)")
    return res


if __name__ == "__main__":
    main()
