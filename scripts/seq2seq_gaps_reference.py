#!/usr/bin/env python3
"""The decode-vs-forward logit gap of seamless-m4t-large-v2 at full width, in
the JAX reference and in the port, on the CPU.

On the card the port's prefill and decode steps at full width and depth (24
encoder and 24 decoder layers, d 1024, an untied 256,206-row head) are
further from ``decoder_seq`` + ``logits_from_hidden``'s logits at the same
positions than the reference's own bar of 0.05
(tests/test_decode_consistency.py, ``test_seq2seq_prefill_decode_matches_
full``, which holds at ``reduced()`` shapes).  This asks whether the
reference's own decode is as far off its own forward at the same width:
both packages get the same seeded weights (the reference's
``seq2seq.init_params(PRNGKey(0))``, 4-bit float at block 64 by default,
carried across bit for bit with ``interop``), the same stub frames and
tokens and dequant_einsum, and each is measured against itself: the largest
logit gap, over the prefill's last row and the teacher-forced decode steps,
between ``seq2seq.prefill`` + ``decode_step`` and the full forward.  The
reference runs compiled without XLA's excess precision (as the tests hold
it against the port) and with XLA's default.  One JSON line a depth (both
stacks cut to it, ``--depths``) to keep the trees and XLA's compile on a CPU
host (about 1 GB of f32 weights a layer pair a package, and 2.1 GB for the
embedding and head).

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/seq2seq_gaps_reference.py
          [--depths 2,4,8] [--frames 256] [--prefix 2] [--steps 16] [--bits 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import numpy as np

NO_EXCESS = {"xla_allow_excess_precision": False}
NAME = "seamless-m4t-large-v2"


def reference_run(rcfg, params, frames, tokens, prefix, options):
    """The reference's (prefill and decode-step logits [steps + 1, B, V],
    full-forward logits at the same positions) under the XLA compile
    ``options``."""
    import jax
    import jax.numpy as jnp

    from repro.models import seq2seq as rseq

    total = tokens.shape[1]
    fr, toks = jnp.asarray(frames), jnp.asarray(tokens)

    def forward(p, f, t):
        h, _ = rseq.decoder_seq(p, t, rseq.encode(p, f, rcfg), rcfg)
        return rseq.logits_from_hidden(p, h[:, prefix - 1: total - 1], rcfg)

    full = jax.jit(forward).lower(params, fr, toks).compile(compiler_options=options)
    full = np.asarray(full(params, fr, toks), np.float32)
    pf = jax.jit(lambda p, f, t: rseq.prefill(p, f, t, rcfg))
    pf = pf.lower(params, fr, toks[:, :prefix]).compile(compiler_options=options)
    logits, caches = pf(params, fr, toks[:, :prefix])
    ds = jax.jit(lambda p, t, c, pos: rseq.decode_step(p, t, c, pos, rcfg))
    ds = ds.lower(params, toks[:, prefix], caches, jnp.int32(prefix)).compile(
        compiler_options=options)
    steps = [np.asarray(logits, np.float32)]
    for t in range(prefix, total - 1):
        logits, caches = ds(params, toks[:, t], caches, jnp.int32(t))
        steps.append(np.asarray(logits, np.float32))
    return np.stack(steps), full.transpose(1, 0, 2)


def port_run(tcfg, params, frames, tokens, prefix):
    """The port's (prefill and decode-step logits, full-forward logits), as
    above."""
    import torch

    from repro_torch.models import lm, seq2seq

    total = tokens.shape[1]
    fr, toks = torch.from_numpy(frames), torch.from_numpy(tokens).long()
    with torch.inference_mode():
        h, _ = seq2seq.decoder_seq(params, toks, seq2seq.encode(params, fr, tcfg), tcfg)
        full = lm.logits_from_hidden(params, h[:, prefix - 1: total - 1], tcfg).float().numpy()
        del h
        logits, caches = seq2seq.prefill(params, fr, toks[:, :prefix], tcfg)
        steps = [logits.float().numpy()]
        for t in range(prefix, total - 1):
            logits, caches = seq2seq.decode_step(params, toks[:, t], caches, t, tcfg)
            steps.append(logits.float().numpy())
    return np.stack(steps), full.transpose(1, 0, 2)


def one_depth(depth: int, n_frames: int, prefix: int, steps: int, bits: int,
              batch: int) -> dict:
    import jax

    from repro.configs import QuantConfig as RQuantConfig
    from repro.configs.registry import get_arch as r_get_arch
    from repro.models import seq2seq as rseq
    from repro.models.quantize import quantize_params as r_quantize_params
    from repro_torch import interop
    from repro_torch.configs import get_arch

    cut = dict(n_layers=depth, n_encoder_layers=depth)
    rcfg = dataclasses.replace(r_get_arch(NAME), **cut).with_matmul_mode("dequant_einsum")
    tcfg = dataclasses.replace(get_arch(NAME), **cut).with_matmul_mode("dequant_einsum")
    t0 = time.perf_counter()
    params = jax.jit(lambda k: rseq.init_params(k, rcfg))(jax.random.PRNGKey(0))
    if bits < 16:
        q = RQuantConfig(bits=bits, dtype="float", block_size=64)
        params = jax.jit(lambda p: r_quantize_params(p, q, rcfg))(params)
    port = interop.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    rs = np.random.RandomState(depth)
    frames = rs.randn(batch, n_frames, rcfg.d_model).astype(np.float32)
    tokens = rs.randint(0, rcfg.vocab_size, (batch, prefix + steps)).astype(np.int32)
    out = {"arch": NAME, "encoder_depth": depth, "decoder_depth": depth,
           "width": rcfg.d_model, "vocab": rcfg.vocab_size,
           "weights": f"{bits}-bit float b64" if bits < 16 else "f32",
           "frames": n_frames, "prefix": prefix, "decode_steps": steps, "batch": batch}
    runs = {"reference_no_excess": reference_run(rcfg, params, frames, tokens, prefix,
                                                 NO_EXCESS),
            "reference_xla_default": reference_run(rcfg, params, frames, tokens, prefix, {}),
            "port": port_run(tcfg, port, frames, tokens, prefix)}
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
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--prefix", type=int, default=2)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--bits", type=int, default=4, help="weight bits; 16 keeps f32 weights")
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    for depth in (int(d) for d in args.depths.split(",")):
        print(json.dumps(one_depth(depth, args.frames, args.prefix, args.steps, args.bits,
                                   args.batch)), flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
