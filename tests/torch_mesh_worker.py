"""A gloo world of the port on the CPU, for ``tests/test_torch_mesh_serving.py``.

    python tests/torch_mesh_worker.py --mesh 2x2 --inp in.pkl --out out.npz

spawns DATA x MODEL ranks (``torch.multiprocessing``, one thread a rank, a
``file://`` rendezvous beside ``--out``), each joining the world with
``launch/mesh.init_world`` and serving tiny-650k on
``Sharder(make_mesh(DATA, MODEL, "cpu"), replicate_params_below=0)``.  Rank
0 writes every check's numbers to ``--out`` (numpy).  ``--inp`` is a pickle
of {"raw": the reference's init as a tree of numpy arrays, "toks": the
prompts [B, Sp], "n": decode steps, "S": the cache budget, "main": whether
to run ``checks`` (default True), "variants": {name: (config overrides, the
reference's init of that variant)} for ``variant_checks``}.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.launch.mesh import init_world, make_mesh  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.models.sharding import SeqShardFallbackWarning, Sharder  # noqa: E402
from repro_torch.serving import Engine, Server  # noqa: E402

ARCH = "tiny-650k"
#: ring windows: one that does not divide a 2- or 4-way sequence grid (the
#: local fallback) and one that does (the ring sequence-sharded)
RING_FALLBACK, RING_SHARDED = 5, 6


def rollout(cfg, params, toks, S, n, sharder=None, force=None):
    """(tokens [B, n], logits [B, n, V] f32) of prefill + n - 1 decode steps,
    each fed its greedy token or ``force``'s; sharded: the sharder's
    placement and decode read, as the Engine runs them."""
    B, Sp = toks.shape
    kw, read = {}, blocks.local_decode_attn
    if sharder is not None:
        params = sharder.shard_params(params)
        kw = dict(constrain=sharder.constrain, q_pad=sharder.head_pad())
        read = sharder.decode_attn_fn(B, S)
    with torch.inference_mode():
        logits, caches = lm.prefill(params, toks, cfg, cache_len=S, **kw)
        if sharder is not None:
            caches = sharder.shard_caches(caches, B)
        out, logs = [torch.argmax(logits, -1).to(torch.int32)], [logits.float()]
        for t in range(n - 1):
            feed = out[-1] if force is None else torch.as_tensor(force[:, t], dtype=torch.int32)
            logits, caches = lm.decode_step(params, feed, caches, Sp + t, cfg,
                                            decode_attn=read)
            out.append(torch.argmax(logits, -1).to(torch.int32))
            logs.append(logits.float())
    return torch.stack(out, 1).numpy(), torch.stack(logs, 1).numpy()


def serve(params, cfg, prompts, n, *, num_slots, S, sharder=None):
    srv = Server(params, cfg, num_slots=num_slots, max_seq_len=S, sharder=sharder, device="cpu")
    ids = [srv.submit(p, n, arrival_time=0.5 * i) for i, p in enumerate(prompts)]
    res = srv.run_until_drained()
    return np.array([res[i] for i in ids])


def checks(mesh, inp) -> dict:
    cfg = get_arch(ARCH)
    params = interop.params_from_reference(inp["raw"], device="cpu")
    toks = torch.as_tensor(inp["toks"])
    B, n, S = toks.shape[0], inp["n"], inp["S"]
    out = {}

    def sharder(c):
        return Sharder(mesh, c, replicate_params_below=0)

    # bf16 and kv8/kv4, teacher-forced on the port's unsharded greedy tokens
    force, out["port_bf16_logits"] = rollout(cfg, params, toks, S, n)
    out["force"] = force
    _, out["bf16_logits"] = rollout(cfg, params, toks, S, n, sharder(cfg), force)
    for bits in (8, 4):
        c = cfg.with_kv_quant(bits)
        _, out[f"kv{bits}_logits"] = rollout(c, params, toks, S, n, sharder(c), force)
        _, out[f"port_kv{bits}_logits"] = rollout(c, params, toks, S, n, None, force)

    # fused = dequant_einsum under TP, and against the unsharded dequant
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                              device="cpu")
    fused, dq = cfg.with_matmul_mode("fused"), cfg.with_matmul_mode("dequant_einsum")
    out["tf"], out["lf"] = rollout(fused, qparams, toks, S, n, sharder(fused))
    out["td"], out["ld"] = rollout(dq, qparams, toks, S, n, sharder(dq), out["tf"])
    _, out["port_l1"] = rollout(dq, qparams, toks, S, n, None, out["tf"])

    # Engine = Server (one slot) at kv4, per request
    c4 = cfg.with_kv_quant(4)
    eng = Engine(params, c4, max_seq_len=S, sharder=sharder(c4), device="cpu")
    srv = Server(params, c4, num_slots=1, max_seq_len=S, sharder=sharder(c4), device="cpu")
    match = []
    for b in range(B):
        ref = eng.generate(toks[b:b + 1], n - 2)[0].tolist()
        rid = srv.submit(toks[b].numpy(), n - 2)
        match.append(srv.run_until_drained()[rid] == ref)
    out["engine_server_match"] = np.array(match)

    # the 2-slot Server on the mesh against the unsharded one, kv4 on 4-bit weights
    prompts = [toks[b, :L].numpy() for b, L in enumerate((8, 5, 7, 3))]
    out["server_mesh"] = serve(qparams, c4, prompts, 6, num_slots=2, S=S, sharder=sharder(c4))
    out["server_plain"] = serve(qparams, c4, prompts, 6, num_slots=2, S=S)

    # rings: one the grid does not divide (the fallback, warned at setup and
    # at its first read) and one it does
    for w in (RING_FALLBACK, RING_SHARDED):
        ring = dataclasses.replace(cfg, sliding_window=w)
        s = sharder(ring)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            s.decode_attn_fn(B, S)
        out[f"ring{w}_setup_warned"] = any(issubclass(r.category, SeqShardFallbackWarning)
                                           for r in rec)
        out[f"ring{w}_plan"] = np.array(sorted(s.seq_shard_plan(B, S).items()))
        ring_force, _ = rollout(ring, params, toks, S, n)
        out[f"ring{w}_force"] = ring_force
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            _, out[f"ring{w}_logits"] = rollout(ring, params, toks, S, n, s, ring_force)
        out[f"ring{w}_rollout_warned"] = any(issubclass(r.category, SeqShardFallbackWarning)
                                             for r in rec)
    return out


def variant_checks(mesh, name: str, overrides: dict, raw, inp) -> dict:
    """A variant of ARCH (``overrides``: KV groups, q heads, an untied
    head) against its own unsharded rollout: bf16 and kv4 teacher-forced
    on the port's unsharded greedy tokens, and fused = dequant_einsum
    under TP on its 4-bit tree.  Keys are prefixed with ``name``."""
    cfg = dataclasses.replace(get_arch(ARCH), **overrides)
    params = interop.params_from_reference(raw, device="cpu")
    toks, n, S = torch.as_tensor(inp["toks"]), inp["n"], inp["S"]

    def sharder(c):
        return Sharder(mesh, c, replicate_params_below=0)

    out = {"head_pad": np.array(sharder(cfg).head_pad())}
    out["force"], _ = rollout(cfg, params, toks, S, n)
    _, out["bf16_logits"] = rollout(cfg, params, toks, S, n, sharder(cfg), out["force"])
    c4 = cfg.with_kv_quant(4)
    _, out["kv4_logits"] = rollout(c4, params, toks, S, n, sharder(c4), out["force"])
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                              device="cpu")
    fused, dq = cfg.with_matmul_mode("fused"), cfg.with_matmul_mode("dequant_einsum")
    out["tf"], out["lf"] = rollout(fused, qparams, toks, S, n, sharder(fused))
    out["td"], out["ld"] = rollout(dq, qparams, toks, S, n, sharder(dq), out["tf"])
    return {f"{name}_{k}": v for k, v in out.items()}


def rank_main(rank: int, world: int, data: int, model: int, inp_path: str, out_path: str):
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world=world, init_file=out_path + ".rendezvous")
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        mesh = make_mesh(data, model, "cpu")
        out = checks(mesh, inp) if inp.get("main", True) else {}
        for name, (overrides, raw) in inp.get("variants", {}).items():
            out.update(variant_checks(mesh, name, overrides, raw, inp))
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, metavar="DATAxMODEL")
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    data, model = (int(p) for p in args.mesh.split("x"))
    if os.path.exists(args.out + ".rendezvous"):
        os.remove(args.out + ".rendezvous")
    torch.multiprocessing.spawn(rank_main, nprocs=data * model,
                                args=(data * model, data, model, args.inp, args.out))


if __name__ == "__main__":
    main()
