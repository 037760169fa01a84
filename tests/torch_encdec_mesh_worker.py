"""A gloo world of the port's encoder-decoder, sharded slot pool and step
profiler on a mesh, on the CPU, for ``tests/test_torch_encdec_mesh.py``.

    python tests/torch_encdec_mesh_worker.py --mesh 2x2 --inp in.pkl --out out.npz

spawns DATA x MODEL ranks (``torch.multiprocessing``, one thread a rank, a
``file://`` rendezvous beside ``--out``), each joining the world with
``launch/mesh.init_world`` and running the checks named in the input on
``Sharder(make_mesh(DATA, MODEL, "cpu"), cfg, replicate_params_below=0)``.
Rank 0 writes every check's numbers to ``--out`` (numpy; whole gradient
leaves keyed by ``interop.flatten``).  ``--inp`` is a pickle of {"checks":
the checks to run, "raw": {"seamless", "tiny": the reference's inits of
seamless-m4t-large-v2's ``reduced()`` config and of tiny-650k as numpy},
"frames", "bos", "force": a served batch (frames [B, S_m, D], the BOS
prefix, the tokens fed after the prefill), "frames_odd": frames whose
source length does not divide the sequence grid, "train": {"frames",
"tokens", "labels"} and "train_odd" (a batch that does not divide the data
ranks), "ckpt": a directory for the checkpoint round trip, "requests": the
preemption trace, "prompts": the profiled prompts}.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.launch.mesh import init_world, make_mesh  # noqa: E402
from repro_torch.models import lm, seq2seq  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.models.sharding import SeqShardFallbackWarning, Sharder  # noqa: E402
from repro_torch.serving import Engine, Server  # noqa: E402
from repro_torch.serving.profiler import StepProfiler  # noqa: E402
from repro_torch.serving.telemetry import Telemetry  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

SEAMLESS = "seamless-m4t-large-v2"
Q4 = QuantConfig(bits=4, dtype="float", block_size=64)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _seamless(inp):
    cfg = get_arch(SEAMLESS).reduced()
    return cfg, interop.params_from_reference(inp["raw"]["seamless"], device="cpu")


# -- the encoder-decoder served ------------------------------------------------------

def rollout(cfg, params, frames, bos, force, sharder=None):
    """(logits [B, n + 1, V] f32, the caches after, whole) of ``prefill``
    and n teacher-forced ``decode_step``s; sharded: the params and caches
    placed by ``sharder`` and both reads its own."""
    B, T = bos.shape
    kw, step_kw = {}, {}
    if sharder is not None:
        params = sharder.shard_params(params)
        kw = dict(constrain=sharder.constrain, q_pad=sharder.head_pad())
        step_kw = dict(constrain=sharder.constrain,
                       decode_attn=sharder.decode_attn_fn(B, cfg.decoder_cache_len),
                       cross_attn=sharder.cross_attn_fn(B, frames.shape[1]))
    with torch.inference_mode():
        logits, caches = seq2seq.prefill(params, frames, bos, cfg, **kw)
        if sharder is not None:
            caches = sharder.shard_caches(caches, B)
        logs = [logits.float()]
        for t in range(force.shape[1]):
            logits, caches = seq2seq.decode_step(params, force[:, t], caches, T + t, cfg,
                                                 **step_kw)
            logs.append(logits.float())
        if sharder is not None:
            specs = sharder.cache_spec_tree(caches, B)
            caches = tuple({k: sharder.whole(v, specs[i][k]) for k, v in c.items()}
                           for i, c in enumerate(caches))
    return torch.stack(logs, 1), caches


def encdec_serve(mesh, inp) -> dict:
    """seamless's reduced() config served sharded and unsharded, dense and
    4-bit (fused): the teacher-forced logits and the self and cross caches
    after (gathered whole); and over a source length that does not divide
    the sequence grid, the fallback's warnings and logits."""
    cfg, params = _seamless(inp)
    q4 = quantize_params(params, Q4, cfg, device="cpu")
    bos, force = torch.as_tensor(inp["bos"]), torch.as_tensor(inp["force"])
    out = {}
    for tree, p in (("dense", params), ("q4", q4)):
        s = Sharder(mesh, cfg, replicate_params_below=0)
        for case, key in (("even", "frames"), ("odd", "frames_odd")):
            frames = torch.as_tensor(inp[key])
            l0, c0 = rollout(cfg, p, frames, bos, force)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                l1, c1 = rollout(cfg, p, frames, bos, force, s)
            name = f"serve_{tree}_{case}"
            out[name + "_plain"], out[name + "_mesh"] = _np(l0), _np(l1)
            out[name + "_fallbacks"] = np.int64(sum(
                issubclass(w.category, SeqShardFallbackWarning) for w in caught))
            out[name + "_cache_gap"] = np.float64(max(
                _gap(a[k], b[k]) for a, b in zip(c0, c1) for k in a))
            out[name + "_equal"] = np.bool_(torch.equal(l0, l1))
    return out


# -- the encoder-decoder trained --------------------------------------------------------

def encdec_train(mesh, inp) -> dict:
    """One train step's loss and whole gradients on the mesh (the train
    placement, the batch split over the data axes) and unsharded; a batch
    that does not divide the data ranks (whole on each); and the collective
    checkpoint round trip of the mesh's state after one full step."""
    cfg, params = _seamless(inp)
    s = Sharder(mesh, cfg, replicate_params_below=0)
    out = {}
    for case in ("train", "train_odd"):
        batch = {k: torch.as_tensor(v) for k, v in inp[case].items()}
        for tag, sh in (("plain", None), ("mesh", s)):
            step = tstep.make_train_step(cfg, sharder=sh)
            local = step.placement.cut_tree(params) if sh is not None else params
            loss, flat = step.grads(local, batch)
            g = unflatten(local, flat)
            if sh is not None:
                g = step.placement.gather_tree(g)
            out[f"{case}_{tag}_loss"] = np.float64(loss)
            for k, v in interop.flatten(g).items():
                out[f"{case}_{tag}_g{k}"] = _np(v.float())
    batch = {k: torch.as_tensor(v) for k, v in inp["train"].items()}
    state = tstep.init_state(cfg, seed=0, device="cpu")._replace(params=params)
    step = tstep.make_train_step(cfg, sharder=s)
    state, _ = step(state, batch)
    mgr = CheckpointManager(inp["ckpt"], async_save=False)
    mgr.save(1, state, sharder=s)
    torch.distributed.barrier()   # rank 0 has written it
    zero = step.placement.map_state(state, lambda t: unflatten(
        t, [torch.zeros_like(x) for x in leaves(t)]) if t is not None else None)
    _, back, _ = mgr.restore(zero, sharder=s)
    out["ckpt_equal"] = np.bool_(all(
        torch.equal(a, b) for a, b in zip(leaves(state), leaves(back), strict=True)))
    return out


# -- preemption of a sharded pool ---------------------------------------------------

def _record(pool, name: str, slots: list):
    """Wrap ``pool.<name>(slot, ...)`` to append each call's slot."""
    real = getattr(pool, name)

    def wrapped(slot, *a):
        slots.append(slot)
        return real(slot, *a)

    setattr(pool, name, wrapped)


def _margins(cfg, params, prompt, tokens) -> np.ndarray:
    """How far below the unsharded greedy choice each of ``tokens`` is
    (max logit - its logit, f32): the unsharded prefill of ``prompt`` and
    decode steps fed ``tokens``."""
    toks = torch.as_tensor(prompt)[None]
    S = len(prompt) + len(tokens)
    with torch.inference_mode():
        logits, caches = lm.prefill(params, toks, cfg, cache_len=S)
        out = []
        for t, tok in enumerate(tokens):
            lf = logits[0].float()
            out.append(float(lf.max() - lf[int(tok)]))
            if t + 1 < len(tokens):
                logits, caches = lm.decode_step(
                    params, torch.tensor([int(tok)], dtype=torch.int32), caches,
                    len(prompt) + t, cfg)
    return np.array(out)


def preempt(mesh, inp) -> dict:
    """tiny-650k at kv4 on 4-bit weights, a two-slot Server over
    inp["requests"] (two background requests, then an urgent one that evicts
    the later one; the other background request ends first, so the victim
    resumes in the other slot), sharded and unsharded, with preemption and
    without: tokens, the spilled and restored slots, the spill bytes; the
    sharded batch-1 Engine's tokens of each request; and each token's margin
    below the unsharded greedy choice fed the same tokens."""
    cfg = get_arch("tiny-650k").with_kv_quant(4)
    params = interop.params_from_reference(inp["raw"]["tiny"], device="cpu")
    q4 = quantize_params(params, Q4, cfg, device="cpu")
    s = Sharder(mesh, cfg, replicate_params_below=0)
    S = inp["S"]
    reqs = inp["requests"]
    out = {}
    for tag, sh, n_pre in (("plain", None, 1), ("mesh", s, 1), ("mesh_kept", s, 0)):
        tel = Telemetry()
        srv = Server(q4, cfg, num_slots=2, max_seq_len=S, sharder=sh, max_preemptions=n_pre,
                     telemetry=tel, device="cpu")
        spilled, restored = [], []
        _record(srv.pool, "spill_slot", spilled)
        _record(srv.pool, "restore_slot", restored)
        ids = [srv.submit(r["prompt"], r["max_new"], arrival_time=r["arrival_time"],
                          priority=r["priority"]) for r in reqs]
        res = srv.run_until_drained()
        for i, rid in enumerate(ids):
            out[f"preempt_{tag}_tokens{i}"] = np.array(res[rid], dtype=np.int64)
        out[f"preempt_{tag}_n"] = np.int64(srv.scheduler.n_preemptions)
        out[f"preempt_{tag}_spilled"] = np.array(spilled, dtype=np.int64)
        out[f"preempt_{tag}_restored"] = np.array(restored, dtype=np.int64)
        reg = tel.registry
        for kind in ("packed", "logical", "per_device"):
            out[f"preempt_{tag}_bytes_{kind}"] = np.float64(
                reg.counter("kv_spill_bytes_total", kind=kind).value)
        held = torch.tensor([out[f"preempt_{tag}_bytes_per_device"]], dtype=torch.float64)
        if sh is not None:
            every = [torch.zeros_like(held) for _ in range(torch.distributed.get_world_size())]
            torch.distributed.all_gather(every, held)
            out[f"preempt_{tag}_bytes_held"] = torch.cat(every).numpy()
    eng = Engine(q4, cfg, max_seq_len=S, sharder=s, device="cpu")
    for i, r in enumerate(reqs):
        out[f"preempt_engine_tokens{i}"] = eng.generate(
            torch.as_tensor(r["prompt"])[None], r["max_new"])[0].numpy().astype(np.int64)
    for tag in ("plain", "mesh", "engine"):
        for i, r in enumerate(reqs):
            out[f"preempt_{tag}_margins{i}"] = _margins(cfg, q4, r["prompt"],
                                                        out[f"preempt_{tag}_tokens{i}"])
    return out


# -- the step profiler on a mesh ----------------------------------------------------

def _costs(tel) -> dict:
    return {name: pc for sess in tel.profiler.sessions for name, pc in sess.costs.items()}


def profile(mesh, inp) -> dict:
    """tiny-650k at kv4 on 4-bit weights, the profiled Engine and Server,
    sharded and unsharded: every costed program's FLOPs, dot FLOPs, HBM and
    collective bytes, each rank's, and the tokens."""
    import torch.distributed as dist

    cfg = get_arch("tiny-650k").with_kv_quant(4)
    params = interop.params_from_reference(inp["raw"]["tiny"], device="cpu")
    q4 = quantize_params(params, Q4, cfg, device="cpu")
    s = Sharder(mesh, cfg, replicate_params_below=0)
    prompts = torch.as_tensor(inp["prompts"])
    S = inp["S"]
    out = {}
    for tag, sh in (("plain", None), ("mesh", s)):
        tel = Telemetry(profiler=StepProfiler())
        eng = Engine(q4, cfg, max_seq_len=S, sharder=sh, telemetry=tel, device="cpu")
        out[f"profile_{tag}_engine_tokens"] = eng.generate(prompts, 4).numpy()
        tel_s = Telemetry(profiler=StepProfiler())
        srv = Server(q4, cfg, num_slots=2, max_seq_len=S, sharder=sh, telemetry=tel_s,
                     device="cpu")
        ids = [srv.submit(p.numpy(), 4) for p in prompts]
        res = srv.run_until_drained()
        out[f"profile_{tag}_server_tokens"] = np.array([res[i] for i in ids])
        for who, t in (("engine", tel), ("server", tel_s)):
            for name, pc in sorted(_costs(t).items()):
                nums = torch.tensor([pc.flops, pc.dot_flops, pc.hbm_bytes, pc.collective_bytes],
                                    dtype=torch.float64)
                if sh is not None:
                    every = [torch.zeros_like(nums) for _ in range(dist.get_world_size())]
                    dist.all_gather(every, nums)
                    nums = torch.stack(every)
                out[f"profile_{tag}_{who}_{name}"] = nums.numpy()
            out[f"profile_{tag}_{who}_summary"] = np.array(t.profiler.format_summary())
    return out


CHECKS = {"encdec_serve": encdec_serve, "encdec_train": encdec_train, "preempt": preempt,
          "profile": profile}


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
