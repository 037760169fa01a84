#!/usr/bin/env python3
"""The decode-vs-forward logit gap of h2o-danube-3-4b at full width, in the
JAX reference and in the port, on the CPU (ROADMAP C3).

On the card the port's decode steps at full width (24 layers, d 3840, Dh
120) are ~0.19 off ``lm.backbone_seq``'s logits at the same positions,
whatever the cache (``scripts/window_gaps.py``).  This asks whether the
reference's own decode is as far off its own forward, at the same width:
both packages get the same seeded weights (the reference's
``init_params(PRNGKey(0))``, 4-bit float at block 64 by default, carried
across bit for bit with ``interop``), the same tokens, a kv16 cache and
dequant_einsum, and each is measured against itself: the largest logit
gap, over the decode steps, between a prefill of ``--prompt`` tokens
followed by teacher-forced decode steps and the full forward over the
prompt and those tokens.  The reference runs compiled without XLA's excess
precision (as the tests hold it against the port) and with XLA's default.
One JSON line a depth; depth is cut (``--depths``) to keep the two trees
and XLA's compile on a CPU host (about 0.6 GB of f32 weights a layer a
package).

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/window_gaps_reference.py
          [--depths 2,4,8] [--prompt 256] [--steps 16] [--bits 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import numpy as np

NO_EXCESS = {"xla_allow_excess_precision": False}


def reference_run(rcfg, params, tokens, prompt, options):
    """The reference's (decode-step logits [steps, B, V], full-forward logits
    at the same positions) under the XLA compile ``options``."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as rlm

    total = tokens.shape[1]
    toks = jnp.asarray(tokens)
    full = jax.jit(lambda p, t: rlm.logits_from_hidden(
        p, rlm.backbone_seq(p, t, rcfg)[0][:, prompt - 1: total - 1], rcfg))
    full = np.asarray(full.lower(params, toks).compile(compiler_options=options)(params, toks),
                      np.float32)
    pf = jax.jit(lambda p, t: rlm.prefill(p, t, rcfg, cache_len=total))
    pf = pf.lower(params, toks[:, :prompt]).compile(compiler_options=options)
    logits, caches = pf(params, toks[:, :prompt])
    ds = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, t, c, pos, rcfg))
    ds = ds.lower(params, toks[:, prompt], caches, jnp.int32(prompt)).compile(
        compiler_options=options)
    steps = [np.asarray(logits, np.float32)]
    for t in range(prompt, total - 1):
        logits, caches = ds(params, toks[:, t], caches, jnp.int32(t))
        steps.append(np.asarray(logits, np.float32))
    return np.stack(steps), full.transpose(1, 0, 2)


def port_run(tcfg, params, tokens, prompt):
    """The port's (decode-step logits, full-forward logits), as above."""
    import torch

    from repro_torch.models import lm

    total = tokens.shape[1]
    toks = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        h, _ = lm.backbone_seq(params, toks, tcfg)
        full = lm.logits_from_hidden(params, h[:, prompt - 1: total - 1], tcfg).float().numpy()
        del h
        logits, caches = lm.prefill(params, toks[:, :prompt], tcfg, cache_len=total)
        steps = [logits.float().numpy()]
        for t in range(prompt, total - 1):
            logits, caches = lm.decode_step(params, toks[:, t], caches, t, tcfg)
            steps.append(logits.float().numpy())
    return np.stack(steps), full.transpose(1, 0, 2)


def one_depth(depth: int, prompt: int, steps: int, bits: int, batch: int) -> dict:
    import jax

    from repro.configs import QuantConfig as RQuantConfig
    from repro.configs.registry import get_arch as r_get_arch
    from repro.models import lm as rlm
    from repro.models.quantize import quantize_params as r_quantize_params
    from repro_torch import interop
    from repro_torch.configs import get_arch

    name = "h2o-danube-3-4b"
    rcfg = dataclasses.replace(r_get_arch(name), n_layers=depth).with_kv_quant(16) \
        .with_matmul_mode("dequant_einsum")
    tcfg = dataclasses.replace(get_arch(name), n_layers=depth).with_kv_quant(16) \
        .with_matmul_mode("dequant_einsum")
    t0 = time.perf_counter()
    params = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    if bits < 16:
        q = RQuantConfig(bits=bits, dtype="float", block_size=64)
        params = jax.jit(lambda p: r_quantize_params(p, q, rcfg))(params)
    port = interop.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.RandomState(depth).randint(0, rcfg.vocab_size,
                                                  (batch, prompt + steps)).astype(np.int32)
    out = {"depth": depth, "width": rcfg.d_model, "head_dim": rcfg.head_dim,
           "weights": f"{bits}-bit float b64" if bits < 16 else "f32", "kv_bits": 16,
           "prompt": prompt, "decode_steps": steps, "batch": batch}
    runs = {"reference_no_excess": reference_run(rcfg, params, tokens, prompt, NO_EXCESS),
            "reference_xla_default": reference_run(rcfg, params, tokens, prompt, {}),
            "port": port_run(tcfg, port, tokens, prompt)}
    for key, (dec, full) in runs.items():
        out[f"{key}_decode_vs_forward"] = float(np.abs(dec - full).max())
    out["max_abs_logit"] = float(np.abs(runs["port"][1]).max())
    out["port_vs_reference_forward"] = float(
        np.abs(runs["port"][1] - runs["reference_no_excess"][1]).max())
    out["port_vs_reference_decode"] = float(
        np.abs(runs["port"][0] - runs["reference_no_excess"][0]).max())
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="2,4,8")
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--bits", type=int, default=4, help="weight bits; 16 keeps f32 weights")
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    for depth in (int(d) for d in args.depths.split(",")):
        print(json.dumps(one_depth(depth, args.prompt, args.steps, args.bits, args.batch)),
              flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
