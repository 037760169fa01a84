"""A gloo world of the port's mixture-of-experts, SSM and hybrid decoders on
a mesh, on the CPU, for ``tests/test_torch_moe_ssm_mesh.py``.

    python tests/torch_moe_ssm_mesh_worker.py --mesh 2x2 --inp in.pkl --out out.npz

spawns DATA x MODEL ranks (``torch.multiprocessing``, one thread a rank, a
``file://`` rendezvous beside ``--out``), each joining the world with
``launch/mesh.init_world`` and running the checks named in the input on
``Sharder(make_mesh(DATA, MODEL, "cpu"), cfg, replicate_params_below=0)``
for the ``reduced()`` configs of moonshot-v1-16b-a3b, mamba2-130m and
jamba-v0.1-52b.  Rank 0 writes every check's numbers to ``--out`` (numpy;
whole gradient leaves keyed by ``interop.flatten``).  ``--inp`` is a pickle
of {"raw": {short name: the reference's init of that config as numpy},
"checks": the checks to run, "moe_x", "ssm_u": layer inputs, "tokens",
"labels": a training batch, "prompts": prompts, "force": {short name: the
tokens fed after the prefill}, "n": decode steps, "S": the cache budget}.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import init_world, make_mesh  # noqa: E402
from repro_torch.models import blocks, lm, moe, ssm  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.models.sharding import Sharder  # noqa: E402
from repro_torch.serving import Engine, Server  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCHS = {"moonshot": "moonshot-v1-16b-a3b", "mamba2": "mamba2-130m",
         "jamba": "jamba-v0.1-52b"}
#: the training checks' MoE capacity factor: low enough that every group
#: drops tokens, so capacity and drops must be the unsharded run's
DROP_CAPACITY = 0.5
#: the MoE layer's training loss: sum(y * r) + AUX_WEIGHT * aux, the aux
#: weighted so its gradient is a large part of the router's and of x's
AUX_WEIGHT = 1000.0
#: SSM variants of mamba2's reduced() config: its 8 heads, 6 heads that a
#: 4-way "model" axis does not divide (kept whole there), and 2 groups of 4
#: heads (each rank's heads read their own group)
SSM_VARIANTS = {"base": {}, "whole_heads": dict(ssm_expand=3, ssm_head_dim=32),
                "groups": dict(ssm_groups=2)}


def cfg_of(name: str, **overrides):
    return dataclasses.replace(get_arch(ARCHS[name]).reduced(), **overrides)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _bf16(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16)


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- the MoE layer alone ----------------------------------------------------------

#: (batch, seq, masked, decode): 16 dispatch groups (T = 256), one group
#: (T = 48), one group under a pad mask, and a decode step with idle rows
MOE_CASES = {"g16": (4, 64, False, False), "g1": (2, 24, False, False),
             "masked": (2, 24, True, False), "decode": (4, 1, True, True)}


def moe_layer_serve(mesh, inp) -> dict:
    """The MoE layer of moonshot's reduced() config on the same whole input
    on every rank, sharded and unsharded: dense experts (dequant_einsum) and
    4-bit ones (fused: the per-expert prefill GEMM, the expert-batched GEMV
    at decode), each case of MOE_CASES."""
    cfg = cfg_of("moonshot")
    params = interop.params_from_reference(inp["raw"]["moonshot"], device="cpu")
    q4 = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                         device="cpu")
    out = {}
    x_all = _bf16(inp["moe_x"])
    for tree, p, mode in (("dense", params, "dequant_einsum"), ("q4", q4, "fused"),
                          ("q4dq", q4, "dequant_einsum")):
        c = cfg.with_matmul_mode(mode)
        s = Sharder(mesh, c, replicate_params_below=0)
        whole = blocks.take(p["stack"][0], 0)["ffn"]
        mine = blocks.take(s.shard_params(p)["stack"][0], 0)["ffn"]
        for case, (B, S, masked, decode) in MOE_CASES.items():
            x = x_all[:B * S].reshape(B, S, -1)
            pm = None
            if masked:
                pm = torch.ones((B, S), dtype=torch.bool)
                pm[0, S - 5:] = False      # a padded row (or an idle one at decode)
            with torch.inference_mode():
                y0, a0 = moe.moe_ffn(whole, x, c, pm, decode=decode)
                y1, a1 = moe.moe_ffn(mine, x, c, pm, decode=decode, constrain=s.constrain)
            key = f"moe_serve_{tree}_{case}"
            out[key + "_equal"] = np.bool_(torch.equal(y0, y1) and all(
                torch.equal(a0[k], a1[k]) for k in a0))
            out[key + "_gap"] = np.float64(_gap(y0, y1))
    return out


def _train_grads(cfg, params, sharder, fn, x):
    """(loss, whole gradients of the params tree, whole gradient of x) of
    ``fn(live params, x, constrain)`` -> (per-rank partial sum, global term):
    unsharded without ``sharder``, else on the train placement with x's rows
    split over the data axes (its gradient gathered back)."""
    if sharder is None:
        flat = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
        xg = x.detach().clone().requires_grad_(True)
        part, glob = fn(unflatten(params, flat), xg, blocks.NO_CONSTRAIN)
        loss = part + glob
        grads = torch.autograd.grad(loss, [xg] + flat, allow_unused=True)
        g = [torch.zeros_like(t) if d is None else d for t, d in zip(flat, grads[1:])]
        return float(loss.detach()), unflatten(params, g), grads[0]
    pl = sharder.train_placement()
    view = pl.sharder
    flat = [t.detach().clone().requires_grad_(True) for t in leaves(pl.cut_tree(params))]
    d_idx, d_n = view.constrain.batch_share()
    b = x.shape[0] // d_n
    xg = x[d_idx * b:(d_idx + 1) * b].detach().clone().requires_grad_(True)
    part, glob = fn(pl.live(flat), xg, view.constrain)
    loss = view.constrain.batch_sum(part) + glob
    grads = torch.autograd.grad(loss, [xg] + flat, allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d for t, d in zip(flat, grads[1:])]
    g = pl.reduce_grads(g)
    gx = grads[0]
    if view.dp_axes:
        gx = ops.gather_dim(gx, 0, view.group(view.dp_axes))
    return float(loss.detach()), pl.gather_tree(unflatten(params, g)), gx


def moe_layer_train(mesh, inp) -> dict:
    """The MoE layer of moonshot's reduced() config with a capacity that
    drops tokens, trained on the train placement (batch rows over the data
    axes): the loss sum(y * r) + AUX_WEIGHT * aux and the gradients of x
    and of the layer's leaves, sharded and unsharded, for one dispatch
    group (T = 64: the tokens gathered over the data axes) and 16 (T =
    256: each data rank's rows whole groups)."""
    cfg = cfg_of("moonshot", capacity_factor=DROP_CAPACITY)
    params = interop.params_from_reference(inp["raw"]["moonshot"], device="cpu")
    s = Sharder(mesh, cfg, replicate_params_below=0)
    out = {}
    for case, (B, S) in {"g1": (4, 16), "g16": (4, 64)}.items():
        x = _bf16(inp["moe_x"][:B * S]).reshape(B, S, -1)
        r = _bf16(inp["moe_r"][:B * S]).reshape(B, S, -1)

        def fn(p, xl, constrain, B=B, r=r):
            d_idx, d_n = constrain.batch_share()
            b = B // d_n
            y, aux = moe.moe_ffn(blocks.take(p["stack"][0], 0)["ffn"], xl, cfg,
                                 constrain=constrain)
            part = (y.float() * r[d_idx * b:(d_idx + 1) * b].float()).sum()
            return part, AUX_WEIGHT * aux["moe_aux"]

        for name, sh in (("plain", None), ("mesh", s)):
            with _Routes() as routes:
                loss, g, gx = _train_grads(cfg, params, sh, fn, x)
            key = f"moe_train_{case}_{name}"
            out[key + "_dropped"] = np.int64(sum(int((~_kept(i, cfg)).sum())
                                                 for i in routes.ids))
            out[key + "_loss"] = np.float64(loss)
            out[key + "_gx"] = _np(gx.float())
            for k, v in interop.flatten(g).items():
                if "['ffn']" in k:
                    out[f"{key}_g{k}"] = _np(v.float())
    return out


# -- the SSM layer alone -----------------------------------------------------------

def _layer_cache(sharder, tail, B):
    """This rank's slice of a layer's whole SSM tail (its rows, heads and
    channels), as ``shard_caches`` places a stack of them."""
    one = ({k: v[None] for k, v in tail.items()},)
    return {k: v[0].clone() for k, v in sharder.shard_caches(one, B)[0].items()}


def ssm_layer(mesh, inp) -> dict:
    """The SSM layer (layer 0's mixer) of mamba2's reduced() config and its
    SSM_VARIANTS, sharded and unsharded on the same whole input: the
    sequence mode's output and tail (state and conv), then n decode steps
    from the tail, and the caches those leave (gathered whole)."""
    out = {}
    n = inp["n"]
    for name, over in SSM_VARIANTS.items():
        cfg = cfg_of("mamba2", **over)
        params = (interop.params_from_reference(inp["raw"]["mamba2"], device="cpu")
                  if not over else lm.init_params(cfg, seed=3, device="cpu"))
        s = Sharder(mesh, cfg, replicate_params_below=0)
        u = _bf16(inp["ssm_u"][..., :cfg.d_model])
        B = u.shape[0]
        whole = blocks.take(params["stack"][0], 0)["mixer"]
        mine = blocks.take(s.shard_params(params)["stack"][0], 0)["mixer"]
        with torch.inference_mode():
            y0, t0 = ssm.ssm_block(whole, u[:, :-n], cfg)
            y1, t1 = ssm.ssm_block(mine, u[:, :-n], cfg, constrain=s.constrain)
            c0 = {k: v.clone() for k, v in t0.items()}
            c1 = _layer_cache(s, t1, B)
            d0 = [ssm.ssm_block_decode(whole, u[:, -n + t], c0, cfg) for t in range(n)]
            d1 = [ssm.ssm_block_decode(mine, u[:, -n + t], c1, cfg, constrain=s.constrain)
                  for t in range(n)]
            spec = s.cache_spec_tree(({k: v[None] for k, v in t1.items()},), B)[0]
            back = {k: s.whole(v[None], spec[k])[0] for k, v in c1.items()}
        key = f"ssm_{name}"
        out[key + "_heads_split"] = np.bool_(c1["state"].shape[1] != cfg.n_ssm_heads)
        out[key + "_seq_gap"] = np.float64(_gap(y0, y1))
        out[key + "_tail_gap"] = np.float64(max(_gap(t0[k], t1[k]) for k in t0))
        out[key + "_decode_gap"] = np.float64(max(_gap(a, b) for a, b in zip(d0, d1)))
        out[key + "_cache_gap"] = np.float64(max(_gap(c0[k], back[k]) for k in c0))
        out[key + "_seq_equal"] = np.bool_(torch.equal(y0, y1) and all(
            torch.equal(t0[k], t1[k]) for k in t0))
    return out


# -- whole models -------------------------------------------------------------------

class _Routes:
    """Within the block, each router's top-k expert ids (``moe.route``), in
    call order."""

    def __enter__(self):
        self.real, self.ids = moe.route, []

        def route(params, xt, cfg):
            probs, gates, idx = self.real(params, xt, cfg)
            self.ids.append(idx.detach().clone())
            return probs, gates, idx

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.real
        return False


def _kept(idx: torch.Tensor, cfg) -> torch.Tensor:
    """Which (token, choice) pairs of one unmasked router call (ids [G, Tg,
    k]) keep their slot: moe_ffn's exclusive per-group position against the
    group's capacity."""
    G, Tg, k = idx.shape
    flat = torch.nn.functional.one_hot(idx, cfg.n_experts).reshape(G, Tg * k, -1)
    pos = ((torch.cumsum(flat, 1) - flat) * flat).sum(-1).reshape(G, Tg, k)
    return pos < moe.capacity(Tg, cfg)


def _flips(mine: list, want: list, cfg) -> tuple[int, int]:
    """(top-k choices, kept slots) that differ between two runs' routes; a
    call whose tokens differ in number differs in every choice."""
    ids = kept = 0
    for a, b in zip(mine, want, strict=True):
        if a.shape != b.shape:
            ids, kept = ids + a.numel(), kept + a.numel()
            continue
        ids += int((a != b).sum())
        kept += int((_kept(a, cfg) != _kept(b, cfg)).sum())
    return ids, kept


def _flipped_rows(mine: list, want: list, cfg, batch: int) -> np.ndarray:
    """Which rows of a rollout's batch have a token whose top-k choices or
    kept slots differ between two runs' routes, at any call (a call's tokens
    are its batch's rows, in order)."""
    rows = np.zeros(batch, dtype=bool)
    for a, b in zip(mine, want, strict=True):
        diff = ((a != b) | (_kept(a, cfg) != _kept(b, cfg))).any(-1).reshape(-1)
        per_row = diff.numel() // batch
        rows |= diff.reshape(batch, per_row).any(-1).numpy()
    return rows


def rollout(cfg, params, toks, S, n, sharder=None, force=None):
    """(tokens [B, n], logits [B, n, V] f32, the routers' ids) of prefill and
    n - 1 decode steps, each fed ``force``'s token (or its own greedy one);
    sharded: the sharder's placement, decode read and constrain, as the
    Engine runs them."""
    B, Sp = toks.shape
    kw, step_kw = {}, {}
    if sharder is not None:
        params = sharder.shard_params(params)
        kw = dict(constrain=sharder.constrain, q_pad=sharder.head_pad())
        step_kw = dict(constrain=sharder.constrain, decode_attn=sharder.decode_attn_fn(B, S))
    with torch.inference_mode(), _Routes() as routes:
        logits, caches = lm.prefill(params, toks, cfg, cache_len=S, **kw)
        if sharder is not None:
            caches = sharder.shard_caches(caches, B)
        out, logs = [torch.argmax(logits, -1).to(torch.int32)], [logits.float()]
        for t in range(n - 1):
            feed = out[-1] if force is None else torch.as_tensor(force[:, t], dtype=torch.int32)
            logits, caches = lm.decode_step(params, feed, caches, Sp + t, cfg, **step_kw)
            out.append(torch.argmax(logits, -1).to(torch.int32))
            logs.append(logits.float())
    return torch.stack(out, 1).numpy(), torch.stack(logs, 1).numpy(), routes.ids


def models_serve(mesh, inp) -> dict:
    """Each arch's reduced() config served: the sharded teacher-forced
    logits (bf16 cache, fed inp["force"][name], the port's unsharded greedy
    tokens) beside the port's unsharded ones, with router flips counted;
    then at kv4 on 4-bit weights the sharded Server's tokens (one slot: the
    batch-1 Engine's decode plan; mamba2 also on 2) against the sharded
    batch-1 Engine's."""
    out = {}
    toks = torch.as_tensor(inp["prompts"])
    n, S = inp["n"], inp["S"]
    for name in ARCHS:
        cfg = cfg_of(name)
        params = interop.params_from_reference(inp["raw"][name], device="cpu")
        s = Sharder(mesh, cfg, replicate_params_below=0)
        force = inp["force"][name]
        _, plain, r0 = rollout(cfg, params, toks, S, n, force=force)
        _, mine, r1 = rollout(cfg, params, toks, S, n, s, force)
        out[f"{name}_port_logits"], out[f"{name}_logits"] = plain, mine
        if cfg.n_experts:
            out[f"{name}_route_flips"] = np.array(_flips(r1, r0, cfg))
            out[f"{name}_flipped_rows"] = _flipped_rows(r1, r0, cfg, toks.shape[0])
        c4 = cfg.with_kv_quant(4)
        q4 = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                             device="cpu")
        s4 = Sharder(mesh, c4, replicate_params_below=0)
        lens = (8, 16, 8) if name != "moonshot" else (8, 5, 13)
        prompts = [toks[i % toks.shape[0], :L].numpy() for i, L in enumerate(lens)]
        eng = Engine(q4, c4, max_seq_len=S, sharder=s4, device="cpu")
        want = [eng.generate(torch.as_tensor(p)[None], 6)[0].tolist() for p in prompts]
        # mamba2 reads no attention, so its pool's rows may also split over
        # "data" (2 slots) without a combine in another order
        for slots in (1, 2) if name == "mamba2" else (1,):
            srv = Server(q4, c4, num_slots=slots, max_seq_len=S, sharder=s4, device="cpu")
            ids = [srv.submit(p, 6, arrival_time=0.5 * i) for i, p in enumerate(prompts)]
            res = srv.run_until_drained()
            out[f"{name}_server{slots}_engine_match"] = np.array(
                [res[i] == w for i, w in zip(ids, want)])
    return out


def models_train(mesh, inp) -> dict:
    """One train step's global loss and whole gradients of each arch named
    in inp["train_archs"] (reduced()), on the mesh (the train placement:
    FSDP storage, the batch's rows over the data axes) and unsharded, with
    router flips of the sharded forward against the unsharded one."""
    out = {}
    batch = {"tokens": torch.as_tensor(inp["tokens"]), "labels": torch.as_tensor(inp["labels"])}
    for name in inp["train_archs"]:
        cfg = cfg_of(name)
        params = interop.params_from_reference(inp["raw"][name], device="cpu")
        s = Sharder(mesh, cfg, replicate_params_below=0)
        runs = {}
        for tag, sh in (("plain", None), ("mesh", s)):
            step = tstep.make_train_step(cfg, sharder=sh, loss_chunk=inp["loss_chunk"])
            local = step.placement.cut_tree(params) if sh is not None else params
            with _Routes() as routes:
                loss, flat = step.grads(local, batch)
            g = unflatten(local, flat)
            if sh is not None:
                g = step.placement.gather_tree(g)
            runs[tag] = routes.ids
            out[f"{name}_train_{tag}_loss"] = np.float64(loss)
            for k, v in interop.flatten(g).items():
                out[f"{name}_train_{tag}_g{k}"] = _np(v.float())
        if cfg.n_experts:
            d_idx, d_n = s.training().constrain.batch_share()
            mine, want = runs["mesh"], runs["plain"]
            if mine and mine[0].shape[0] * d_n == want[0].shape[0] and d_n > 1:
                # this rank's whole groups: its groups of the unsharded routes
                g = mine[0].shape[0]
                want = [r[d_idx * g:(d_idx + 1) * g] for r in want]
            out[f"{name}_train_route_flips"] = np.array(_flips(mine, want, cfg))
    return out


CHECKS = {"moe_serve": moe_layer_serve, "moe_train": moe_layer_train, "ssm": ssm_layer,
          "models_serve": models_serve, "models_train": models_train}


def rank_main(rank: int, world: int, data: int, model: int, inp_path: str, out_path: str):
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world=world, init_file=out_path + ".rendezvous")
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        mesh = make_mesh(data, model, "cpu")
        out = {}
        for name in inp["checks"]:
            out.update(CHECKS[name](mesh, inp))
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
