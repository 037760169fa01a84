#!/usr/bin/env python3
"""Op by op, the port's seamless-m4t-large-v2 decode step against the JAX
reference's, on the CPU, from the same inputs.

The port's decode is further from its own forward than the reference's
(ROADMAP C6; ``scripts/seq2seq_gaps_reference.py``).  This finds where: both
packages get the same seeded weights (the reference's ``init_params
(PRNGKey(0))``, 4-bit float at block 64, carried across bit for bit with
``interop``), the reference's prefill (compiled without XLA's excess
precision) fills the caches, which are carried across too, and the first
decode step is taken op by op.  Each op of each decoder layer runs in both
packages on the REFERENCE's inputs (the reference's ops compiled one at a
time without excess precision), so each line measures that op alone: the
largest difference in units of the last place (ulp) of the reference's
output dtype at each element, and the share of elements that differ.  A
second pass chains each package's own outputs (``chained``): how the
differences grow through the layers.  Then each package's dense products
(layer 0's up and down projections, the head) on the decode's B rows alone
against the same rows among M (the forward's B x (P + 1), 16, 32, 64):
whether a row's result depends on the row count of its call.  Finally the decode-vs-forward
gap of each package at this position (``decoder_seq`` over prefix + token).

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/seq2seq_decode_ops.py
          [--depth 2] [--frames 64] [--prefix 4] [--batch 2] [--bits 4]

One JSON line an op and layer, then a summary line with the first op whose
isolated difference passes one ulp.  Full width; cut the depth to keep the
trees on a CPU host (about 1 GB of weights a layer pair a package).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

NO_EXCESS = {"xla_allow_excess_precision": False}
NAME = "seamless-m4t-large-v2"


def ulps(port, ref) -> tuple[float, float, float]:
    """(max |port - ref| in ulps of ref's dtype at each element, share of
    elements that differ, max |port - ref|), both as float64."""
    ref_np = np.asarray(ref)
    bits = {"bfloat16": 8, "float32": 24}[ref_np.dtype.name]
    r = ref_np.astype(np.float64)
    p = np.asarray(port).astype(np.float64)
    diff = np.abs(p - r)
    _, exp = np.frexp(np.maximum(np.abs(r), np.finfo(np.float32).tiny))
    ulp = np.ldexp(1.0, exp - bits)
    return float((diff / ulp).max()), float((diff > 0).mean()), float(diff.max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--prefix", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--bits", type=int, default=4, help="weight bits; 16 keeps f32 weights")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import QuantConfig as RQuantConfig
    from repro.configs.registry import get_arch as r_get_arch
    from repro.models import attention as rattn
    from repro.models import blocks as rblocks
    from repro.models import layers as rlayers
    from repro.models import lm as rlm
    from repro.models import seq2seq as rseq
    from repro.models.quantize import quantize_params as r_quantize_params
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.models import attention as tattn
    from repro_torch.models import blocks as tblocks
    from repro_torch.models import layers as tlayers
    from repro_torch.models import lm as tlm
    from repro_torch.models import seq2seq as tseq

    torch.set_num_threads(4)
    cut = dict(n_layers=args.depth, n_encoder_layers=args.depth)
    rcfg = dataclasses.replace(r_get_arch(NAME), **cut).with_matmul_mode("dequant_einsum")
    tcfg = dataclasses.replace(get_arch(NAME), **cut).with_matmul_mode("dequant_einsum")
    mm = rcfg.matmul_mode
    rparams = jax.jit(lambda k: rseq.init_params(k, rcfg))(jax.random.PRNGKey(0))
    if args.bits < 16:
        q = RQuantConfig(bits=args.bits, dtype="float", block_size=64)
        rparams = jax.jit(lambda p: r_quantize_params(p, q, rcfg))(rparams)
    tparams = interop.params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    rs = np.random.RandomState(0)
    B, P = args.batch, args.prefix
    frames = rs.randn(B, args.frames, rcfg.d_model).astype(np.float32)
    tokens = rs.randint(0, rcfg.vocab_size, (B, P + 1)).astype(np.int32)

    def rjit(fn, *xs):
        """The reference's ``fn`` compiled alone, without excess precision."""
        return jax.jit(fn).lower(*xs).compile(compiler_options=NO_EXCESS)(*xs)

    def t(a):
        return interop.tensor_from_numpy(np.asarray(a), device="cpu")

    # the reference's prefill fills both packages' caches
    _, (self_c, (kx, vx)) = rjit(lambda p, f, tk: rseq.prefill(p, f, tk, rcfg), rparams,
                                 jnp.asarray(frames), jnp.asarray(tokens[:, :P]))
    S_m = kx.shape[2]
    tok = tokens[:, P]
    pos = P
    lines, first = [], None

    def record(layer, op, port_out, ref_out, mode):
        nonlocal first
        mx, share, absd = ulps(port_out.float().numpy() if isinstance(port_out, torch.Tensor)
                               else port_out, ref_out)
        line = {"mode": mode, "layer": layer, "op": op, "max_ulps": mx, "share_differing": share,
                "max_abs": absd, "dtype": np.asarray(ref_out).dtype.name}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if mode == "isolated" and first is None and mx > 1.0:
            first = line

    def layer_ops(i, x_r, x_t, mode):
        """One decoder layer's ops.  isolated: each port op takes the
        reference's inputs; chained: each package its own."""
        rp = jax.tree.map(lambda a: a[i], rparams["dec_stack"])
        tp = tblocks.take(tparams["dec_stack"], i)
        r_self = jax.tree.map(lambda a: a[i], self_c)
        t_self = {k: t(v) for k, v in r_self.items()}
        r_cross = {"k": kx[i], "v": vx[i], "pos": jnp.arange(S_m, dtype=jnp.int32)}
        t_cross = {k: t(v) for k, v in r_cross.items()}

        def step(op, rfn, tfn, r_in, t_in):
            r_out = rjit(rfn, *r_in)
            t_args = [t(a) for a in r_in] if mode == "isolated" else t_in
            with torch.inference_mode():
                t_out = tfn(*t_args)
            if isinstance(r_out, tuple):
                for j, (port_j, ref_j) in enumerate(zip(t_out, r_out)):
                    record(i, f"{op}[{j}]", port_j, ref_j, mode)
            else:
                record(i, op, t_out, r_out, mode)
            return r_out, t_out

        h_r, h_t = step("self_norm", lambda x: rlayers.norm(rp["self_norm"], x, rcfg.norm_type),
                        lambda x: tlayers.norm(tp["self_norm"], x, tcfg.norm_type), [x_r], [x_t])
        positions = jnp.asarray([pos], jnp.int32)
        (q_r, k_r, v_r), (q_t, k_t, v_t) = step(
            "project_qkv",
            lambda h: rattn.project_qkv(rp["self_attn"], h[:, None, :], rcfg, positions),
            lambda h: tattn.project_qkv(tp["self_attn"], h[:, None, :], tcfg,
                                        torch.tensor([pos], dtype=torch.int32)),
            [h_r], [h_t])
        o_r, o_t = step(
            "self_attention",
            lambda q, k, v: rblocks.local_decode_attn(q[:, 0], k[:, 0], v[:, 0], r_self, pos,
                                                      cap=0.0, window=0)[0],
            lambda q, k, v: tblocks.local_decode_attn(q[:, 0], k[:, 0], v[:, 0],
                                                      {k_: c.clone() for k_, c in
                                                       t_self.items()}, pos),
            [q_r, k_r, v_r], [q_t, k_t, v_t])
        a_r, a_t = step("self_wo",
                        lambda o: rlayers.dense(rp["self_attn"]["wo"], o.reshape(B, -1), mode=mm),
                        lambda o: tlayers.dense(tp["self_attn"]["wo"], o.reshape(B, -1), mode=mm),
                        [o_r], [o_t])
        x_r, x_t = step("self_residual", lambda x, a: x + a, lambda x, a: x + a,
                        [x_r, a_r], [x_t, a_t])
        h_r, h_t = step("cross_norm",
                        lambda x: rlayers.norm(rp["cross_norm"], x, rcfg.norm_type),
                        lambda x: tlayers.norm(tp["cross_norm"], x, tcfg.norm_type), [x_r], [x_t])
        H, Dh = rcfg.n_heads, rcfg.head_dim
        qx_r, qx_t = step("cross_wq",
                          lambda h: rlayers.dense(rp["cross_attn"]["wq"], h, mode=mm)
                          .reshape(B, H, Dh),
                          lambda h: tlayers.dense(tp["cross_attn"]["wq"], h, mode=mm)
                          .reshape(B, H, Dh), [h_r], [h_t])
        ox_r, ox_t = step("cross_attention",
                          lambda q: rattn.decode_attention(q, r_cross, S_m + 1),
                          lambda q: tattn.decode_attention(q, t_cross, S_m + 1), [qx_r], [qx_t])
        a_r, a_t = step("cross_wo",
                        lambda o: rlayers.dense(rp["cross_attn"]["wo"], o.reshape(B, -1),
                                                mode=mm),
                        lambda o: tlayers.dense(tp["cross_attn"]["wo"], o.reshape(B, -1),
                                                mode=mm), [ox_r], [ox_t])
        x_r, x_t = step("cross_residual", lambda x, a: x + a, lambda x, a: x + a,
                        [x_r, a_r], [x_t, a_t])
        h_r, h_t = step("ffn_norm", lambda x: rlayers.norm(rp["ffn_norm"], x, rcfg.norm_type),
                        lambda x: tlayers.norm(tp["ffn_norm"], x, tcfg.norm_type), [x_r], [x_t])
        g_r, g_t = step("ffn_gate", lambda h: rlayers.dense(rp["ffn"]["w_gate"], h, mode=mm),
                        lambda h: tlayers.dense(tp["ffn"]["w_gate"], h, mode=mm), [h_r], [h_t])
        u_r, u_t = step("ffn_up", lambda h: rlayers.dense(rp["ffn"]["w_up"], h, mode=mm),
                        lambda h: tlayers.dense(tp["ffn"]["w_up"], h, mode=mm), [h_r], [h_t])
        m_r, m_t = step("ffn_act_mul", lambda g, u: rlayers.activation(g, rcfg.act) * u,
                        lambda g, u: tlayers.activation(g, tcfg.act) * u, [g_r, u_r], [g_t, u_t])
        d_r, d_t = step("ffn_down", lambda m: rlayers.dense(rp["ffn"]["w_down"], m, mode=mm),
                        lambda m: tlayers.dense(tp["ffn"]["w_down"], m, mode=mm), [m_r], [m_t])
        return step("ffn_residual", lambda x, a: x + a, lambda x, a: x + a,
                    [x_r, d_r], [x_t, d_t])

    for mode in ("isolated", "chained"):
        x_r = rjit(lambda p, tk: p["embed"].astype(jnp.bfloat16)[tk], rparams, jnp.asarray(tok))
        x_t = t(x_r)
        for i in range(args.depth):
            x_r, x_t = layer_ops(i, x_r, x_t, mode)
        fn_r = rjit(lambda p, x: rlayers.norm(p["final_norm"], x, rcfg.norm_type), rparams, x_r)
        with torch.inference_mode():
            fn_t = tlayers.norm(tparams["final_norm"], t(x_r) if mode == "isolated" else x_t,
                                tcfg.norm_type)
            record(args.depth, "final_norm", fn_t, fn_r, mode)
            lg_r = rjit(lambda p, h: rlm.logits_from_hidden(p, h, rcfg), rparams, fn_r)
            lg_t = tlm.logits_from_hidden(tparams, t(fn_r) if mode == "isolated" else fn_t, tcfg)
            record(args.depth, "logits", lg_t, lg_r, mode)

    # the dense products' dependence on the row count: in each package, the
    # decode's B rows alone against the same rows among M rows (the
    # forward's B x (P + 1), and 16, 32, 64), on layer 0's up and down
    # projections and the head
    rows = {}
    rp0 = jax.tree.map(lambda a: a[0], rparams["dec_stack"])
    tp0 = tblocks.take(tparams["dec_stack"], 0)
    for name, width, rfn, tfn in (
            ("ffn_up", rcfg.d_model, lambda x: rlayers.dense(rp0["ffn"]["w_up"], x, mode=mm),
             lambda x: tlayers.dense(tp0["ffn"]["w_up"], x, mode=mm)),
            ("ffn_down", rcfg.d_ff, lambda x: rlayers.dense(rp0["ffn"]["w_down"], x, mode=mm),
             lambda x: tlayers.dense(tp0["ffn"]["w_down"], x, mode=mm)),
            ("head", rcfg.d_model, lambda x: rlm.logits_from_hidden(rparams, x, rcfg),
             lambda x: tlm.logits_from_hidden(tparams, x, tcfg))):
        for M in sorted({B * (P + 1), 16, 32, 64}):
            xb = jnp.asarray(rs.randn(M, width).astype(np.float32)).astype(jnp.bfloat16)
            r_all, r_few = rjit(rfn, xb), rjit(rfn, xb[:B])
            with torch.inference_mode():
                xt = t(xb)
                t_all, t_few = tfn(xt), tfn(xt[:B].clone())
            r_u = ulps(np.asarray(r_few), np.asarray(r_all)[:B])
            t_u = ulps(t_few.float().numpy(), t_all[:B].float().numpy().astype(
                np.asarray(r_all).dtype))
            rows[f"{name}@{M}"] = {"reference_max_abs": r_u[2],
                                   "reference_share_differing": r_u[1],
                                   "port_max_abs": t_u[2], "port_share_differing": t_u[1],
                                   "rows": [B, M]}
            print(json.dumps({"row_count": name, **rows[f"{name}@{M}"]}), flush=True)

    # each package's decode-vs-forward gap at this position
    toks = jnp.asarray(tokens)

    def r_forward(p, f, tk):
        h, _ = rseq.decoder_seq(p, tk, rseq.encode(p, f, rcfg), rcfg)
        return rlm.logits_from_hidden(p, h[:, P], rcfg)

    full_r = np.asarray(rjit(r_forward, rparams, jnp.asarray(frames), toks), np.float32)
    dec_r = np.asarray(rjit(lambda p, tk, c: rseq.decode_step(p, tk, c, P, rcfg)[0], rparams,
                            jnp.asarray(tok), (self_c, (kx, vx))), np.float32)
    with torch.inference_mode():
        tt = torch.from_numpy(tokens).long()
        h, _ = tseq.decoder_seq(tparams, tt, tseq.encode(tparams, torch.from_numpy(frames),
                                                         tcfg), tcfg)
        full_t = tlm.logits_from_hidden(tparams, h[:, P], tcfg).float().numpy()
        _, caches = tseq.prefill(tparams, torch.from_numpy(frames), tt[:, :P], tcfg)
        dec_t = tseq.decode_step(tparams, tt[:, P], caches, P, tcfg)[0].float().numpy()
    summary = {"summary": True, "arch": NAME, "depth": args.depth, "frames": args.frames,
               "prefix": P, "batch": B, "weights": f"{args.bits}-bit float b64"
               if args.bits < 16 else "f32",
               "first_isolated_op_over_one_ulp": first,
               "row_count_dependence": rows,
               "reference_decode_vs_forward": float(np.abs(dec_r - full_r).max()),
               "port_decode_vs_forward": float(np.abs(dec_t - full_t).max()),
               "port_vs_reference_decode": float(np.abs(dec_t - dec_r).max()),
               "port_vs_reference_forward": float(np.abs(full_t - full_r).max())}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
