"""A gloo world of the port's sharded train step on the CPU, for
``tests/test_torch_train_mesh.py``.

    python tests/torch_train_mesh_worker.py --mesh 2x2 --inp in.pkl --out out.npz

spawns DATA x MODEL ranks (``torch.multiprocessing``, one thread a rank, a
``file://`` rendezvous beside ``--out``), each joining the world with
``launch/mesh.init_world`` and training tiny-650k on ``Sharder(make_mesh(
DATA, MODEL, "cpu"), replicate_params_below=0)`` (FSDP storage).  Rank 0
writes every check's numbers to ``--out`` (numpy; whole leaves keyed by
``interop.flatten``).  ``--inp`` is a pickle of {"raw": the reference's init
of tiny-650k as numpy, "tokens", "labels", "masked_labels": a batch and the
same batch with label masks that differ between data ranks, "loss_chunk",
"variants": {name: (config overrides, a seed of the port's init)}, "save":
a directory for the save-and-resume run's checkpoints or None, "resume": a
2x2 run's checkpoint directory to restore here or None}.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch.mesh import init_world, make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.sharding import Sharder  # noqa: E402
from repro_torch.optim import adamw, grad_compress  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCH = "tiny-650k"
#: the save-and-resume run: steps in all, the step it saves at, its batch
TRAIN = dict(steps=4, batch=4, seq_len=32, grad_compress_bits=8)
SAVE_AT = 2


def _np(tree, prefix: str) -> dict:
    """Whole leaves as f32 numpy (bf16 as its bits), keyed under ``prefix``."""
    out = {}
    for k, v in interop.flatten(tree).items():
        v = v.detach()
        out[prefix + k] = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
    return out


def _grads(cfg, params, sharder, batch, *, microbatches=1, loss_chunk):
    """(global loss, this rank's reduced gradients as a tree, the step)."""
    step = tstep.make_train_step(cfg, sharder=sharder, microbatches=microbatches,
                                 loss_chunk=loss_chunk)
    local = step.placement.cut_tree(params)
    loss, flat = step.grads(local, batch)
    return float(loss), unflatten(local, flat), step


def step_checks(mesh, inp) -> dict:
    """One step of tiny-650k sharded: loss and whole gradients (also with 2
    microbatches and with the masked labels), the global norm beside the
    whole tree's, compression of the slices against the whole leaves'."""
    cfg = get_arch(ARCH)
    params = interop.params_from_reference(inp["raw"], device="cpu")
    s = Sharder(mesh, cfg, replicate_params_below=0)
    batch = {"tokens": torch.as_tensor(inp["tokens"]), "labels": torch.as_tensor(inp["labels"])}
    out = {}
    loss, g, step = _grads(cfg, params, s, batch, loss_chunk=inp["loss_chunk"])
    pl = step.placement
    whole = pl.gather_tree(g)
    out["loss"] = np.float64(loss)
    out.update(_np(whole, "g"))
    out["local_bytes"] = np.array([x.numel() * x.element_size() for x in leaves(g)])
    loss2, g2, _ = _grads(cfg, params, s, batch, microbatches=2, loss_chunk=inp["loss_chunk"])
    out["mb2_loss"] = np.float64(loss2)
    out.update(_np(pl.gather_tree(g2), "mb2_g"))
    masked = {**batch, "labels": torch.as_tensor(inp["masked_labels"])}
    loss3, g3, _ = _grads(cfg, params, s, masked, loss_chunk=inp["loss_chunk"])
    out["masked_loss"] = np.float64(loss3)
    out.update(_np(pl.gather_tree(g3), "masked_g"))
    # the global norm: this rank's slices against the whole tree
    gn, gn_whole = adamw.global_norm(g, placement=pl), adamw.global_norm(whole)
    out["norm"], out["norm_whole"] = np.float64(gn), np.float64(gn_whole)
    # compression with error feedback, two rounds, slices against whole leaves
    sg1, se1 = grad_compress.compress_tree(g, None, placement=pl)
    sg2, se2 = grad_compress.compress_tree(g, se1, placement=pl)
    wg1, we1 = grad_compress.compress_tree(whole, None)
    wg2, we2 = grad_compress.compress_tree(whole, we1)
    pairs = [(pl.gather_tree(a), b) for a, b in ((sg1, wg1), (se1, we1), (sg2, wg2),
                                                  (se2, we2))]
    out["compress_equal"] = np.array([all(torch.equal(x, y) for x, y in
                                          zip(leaves(a), leaves(b), strict=True))
                                      for a, b in pairs])
    out["compress_leaves"] = np.int64(sum(math.prod(n) >= grad_compress.MIN_ELEMENTS
                                          for n in pl.shapes))
    return out


def variant_checks(mesh, name: str, overrides: dict, seed: int, inp) -> dict:
    """A variant of ARCH (``overrides``) at the port's own init: the sharded
    loss and whole gradients, keyed under ``name``."""
    cfg = dataclasses.replace(get_arch(ARCH), **overrides)
    params = lm.init_params(cfg, seed=seed, device="cpu")
    s = Sharder(mesh, cfg, replicate_params_below=0)
    batch = {"tokens": torch.as_tensor(inp["tokens"]), "labels": torch.as_tensor(inp["labels"])}
    loss, g, step = _grads(cfg, params, s, batch, loss_chunk=inp["loss_chunk"])
    return {f"{name}_loss": np.float64(loss), f"{name}_head_pad": np.int64(s.head_pad()),
            **_np(step.placement.gather_tree(g), f"{name}_g")}


def save_run(mesh, inp) -> dict:
    """The uninterrupted run's losses, and a run that saves at SAVE_AT (its
    checkpoint under inp["save"]) with its whole state there."""
    cfg = get_arch(ARCH)
    s = Sharder(mesh, cfg, replicate_params_below=0)
    kw = dict(TRAIN, device="cpu", log=lambda *_: None, sharder=s)
    _, full = loop.train(cfg, **kw)
    state, _ = loop.train(cfg, **{**kw, "steps": SAVE_AT}, ckpt_dir=inp["save"],
                          ckpt_every=SAVE_AT)
    whole = s.gather_train_state(state)
    return {"full_losses": np.array(full), **_np(whole, "state")}


def resume_run(mesh, inp) -> dict:
    """The saved checkpoint restored whole, re-placed on this mesh
    (``elastic.remesh_state``) and gathered back; then the run resumed
    here from a copy of it."""
    cfg = get_arch(ARCH)
    s = Sharder(mesh, cfg, replicate_params_below=0)
    template = tstep.init_state(cfg, device="cpu",
                                grad_compress_bits=TRAIN["grad_compress_bits"])
    step, whole, _ = CheckpointManager(inp["resume"]).restore(template)
    local, s2 = elastic.remesh_state(whole, cfg, mesh, sharder=s)
    out = {"restored_step": np.int64(step), **_np(s2.gather_train_state(local), "remesh")}
    out["remesh_local_bytes"] = np.array([x.numel() * x.element_size()
                                          for x in leaves(local.params)])
    copy = inp["resume"] + f"_resumed_{mesh.shape[0]}x{mesh.shape[1]}"
    if torch.distributed.get_rank() == 0:
        shutil.copytree(inp["resume"], copy)
    torch.distributed.barrier()
    logs = []
    _, tail = loop.train(cfg, **TRAIN, device="cpu", log=logs.append, sharder=s,
                         ckpt_dir=copy, ckpt_every=100)
    out["resume_tail"] = np.array(tail)
    out["resume_log"] = np.array(logs[:1])
    return out


def rank_main(rank: int, world: int, data: int, model: int, inp_path: str, out_path: str):
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world=world, init_file=out_path + ".rendezvous")
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        mesh = make_mesh(data, model, "cpu")
        out = {}
        if inp.get("steps", True):
            out.update(step_checks(mesh, inp))
        for name, (overrides, seed) in inp.get("variants", {}).items():
            out.update(variant_checks(mesh, name, overrides, seed, inp))
        if inp.get("save"):
            out.update(save_run(mesh, inp))
        if inp.get("resume"):
            out.update(resume_run(mesh, inp))
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
