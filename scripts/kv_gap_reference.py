#!/usr/bin/env python3
"""The k-bit KV cache's teacher-forced logit gap (``kv_oracle_logit_gap``)
of Qwen2-7B's family at random weights, in the JAX reference and in the
port, on the CPU, beside the reference's stated ``KV_LOGIT_TOL``.

The tolerance (``{8: 0.2, 4: 1.0}``, ``serving/engine.py``) is stated for
the tiny family.  On the card the port's gap at Qwen2-7B's full width and
depth (seeded random weights, 4-bit float at block 64) is far above it.
This asks whether the reference misses it too: both packages get the same
weights (the reference's ``lm.init_params(PRNGKey(0))``, quantized, carried
across bit for bit with ``interop``) and the same probe (the first 4
prompts of the reference's ``serving_workload``, cut to the shortest, 16
steps, as ``benchmarks/serve_bench.py`` builds it), at ``qwen2-7b``'s
``reduced()`` shapes and at cuts of it toward full size: Qwen2-7B's 28
layers, and wider (``--widths``).  One JSON line a (cut, kv bits): both
gaps, both greedy agreements and the tolerance.

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/kv_gap_reference.py
          [--depths 2,28] [--widths 64,512]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

ARCH = "qwen2-7b"


def cut_config(get_arch, d_model: int, depth: int):
    """qwen2-7b's reduced() at ``d_model`` wide (heads of 16 at 64, of 64
    past it; kv heads one in 7 as Qwen2-7B's 4 of 28, at least 2) and
    ``depth`` layers."""
    head_dim = 16 if d_model <= 64 else 64
    n_heads = d_model // head_dim
    return get_arch(ARCH).reduced(
        d_model=d_model, n_layers=depth, n_heads=n_heads, head_dim=head_dim,
        n_kv_heads=max(2, n_heads // 7), d_ff=2 * d_model if d_model <= 64 else 5 * d_model,
        vocab_size=256 if d_model <= 64 else 4096)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="2,28")
    ap.add_argument("--widths", default="64,512")
    args = ap.parse_args()

    import jax
    import torch

    from repro.configs import QuantConfig as RQuantConfig
    from repro.configs.registry import get_arch as r_get_arch
    from repro.data import synthetic as rsyn
    from repro.models import lm as rlm
    from repro.models.quantize import quantize_params as r_quantize_params
    from repro.serving import KV_LOGIT_TOL
    from repro.serving import kv_oracle_logit_gap as r_gap
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.serving import kv_oracle_logit_gap as t_gap

    torch.set_num_threads(4)
    # the reference's steps compiled (its gap calls them op by op)
    rlm.prefill = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
    rlm.decode_step = jax.jit(rlm.decode_step, static_argnums=(4,))
    for width in (int(w) for w in args.widths.split(",")):
        for depth in (int(d) for d in args.depths.split(",")):
            t0 = time.perf_counter()
            rcfg = cut_config(r_get_arch, width, depth)
            tcfg = cut_config(get_arch, width, depth)
            rparams = r_quantize_params(rlm.init_params(jax.random.PRNGKey(0), rcfg),
                                        RQuantConfig(bits=4, dtype="float", block_size=64),
                                        rcfg)
            tparams = interop.params_from_reference(jax.tree.map(np.asarray, rparams),
                                                    device="cpu")
            reqs = rsyn.serving_workload(rcfg.vocab_size, 4, max_new_range=(8, 48), rate=4.0,
                                         seed=0)
            L = min(len(r["prompt"]) for r in reqs)
            probe = np.stack([r["prompt"][:L] for r in reqs])
            for bits in (8, 4):
                r_g, r_agree = r_gap(rparams, rcfg.with_kv_quant(bits), probe, 16)
                t_g, t_agree = t_gap(tparams, tcfg.with_kv_quant(bits), probe, 16,
                                     device="cpu")
                print(json.dumps({
                    "arch": ARCH, "d_model": width, "depth": depth, "n_heads": rcfg.n_heads,
                    "n_kv_heads": rcfg.n_kv_heads, "head_dim": rcfg.head_dim,
                    "vocab": rcfg.vocab_size, "weights": "4-bit float b64", "kv_bits": bits,
                    "reference_gap": float(r_g), "port_gap": t_g,
                    "reference_greedy_agree": float(r_agree), "port_greedy_agree": t_agree,
                    "kv_logit_tol": KV_LOGIT_TOL[bits],
                    "reference_misses_tol": bool(float(r_g) >= KV_LOGIT_TOL[bits]),
                    "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
