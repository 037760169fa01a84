#!/usr/bin/env python3
"""The sharded train step's numbers on the CPU: its gaps to the unsharded
step and to the reference's sharded step, and the collectives a step
issues.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_mesh_gaps.py [--skip-gaps]

Gaps (~2 min): the gloo worlds and the reference's sharded step of
``tests/test_torch_train_mesh.py`` (its helpers, the same inputs), printed
as the loss gap and the worst gradient leaf's gap over its max |g| per
world (2x2, 1x4, 4x1; 2 microbatches against 1; the uneven label masks;
the padded-GQA variant at 1x4), the 2x2 step against the reference's
sharded step, and a 2x2 run resumed on 1x2 against the uninterrupted run.
Collectives (~10 s): one train step on a 1x1 gloo world, counted by kind,
for Qwen2-7B's config at ``reduced()`` widths and depth 4 with 2
microbatches (chip_smoke's train mesh phase) and for tiny-650k.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def gaps(tmp: Path) -> None:
    import numpy as np

    import test_torch_train_mesh as T

    loss, grads = T._unsharded()
    for mesh in T.STEP_WORLDS:
        extra = {"save": str(tmp / "ckpt")} if mesh == "2x2" else (
            {"variants": {"pad": (T.PAD, 0)}} if mesh == "1x4" else {})
        w = T._spawn(mesh, tmp, **extra)
        m_loss, m_grads = T._unsharded("masked")
        print(mesh, {"loss_gap": abs(float(w["loss"]) - loss),
                     "grad_gap": T._within(T._grads(w, "g"), grads),
                     "microbatches_2_vs_1": T._within(T._grads(w, "mb2_g"), T._grads(w, "g")),
                     "masked_loss_gap": abs(float(w["masked_loss"]) - m_loss),
                     "masked_grad_gap": T._within(T._grads(w, "masked_g"), m_grads),
                     "norm_rel": abs(float(w["norm"]) - float(w["norm_whole"]))
                     / float(w["norm_whole"])}, flush=True)
        if mesh == "1x4":
            p_loss, p_grads = T._unsharded("pad")
            print(" pad", {"loss_gap": abs(float(w["pad_loss"]) - p_loss),
                           "grad_gap": T._within(T._grads(w, "pad_g"), p_grads)}, flush=True)
    raw, tokens, labels, _ = T._inputs()
    with open(tmp / "ref.pkl", "wb") as f:
        pickle.dump({"raw": raw, "tokens": tokens, "labels": labels,
                     "loss_chunk": T.LOSS_CHUNK}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    subprocess.run([sys.executable, str(T.REFERENCE), "--mesh", "2x2", "--inp",
                    str(tmp / "ref.pkl"), "--out", str(tmp / "ref.npz")], env=env, check=True)
    ref = dict(np.load(tmp / "ref.npz"))
    ref_g = {k: v for k, v in ref.items() if k != "loss"}
    w = T._WORLDS["2x2"]
    print("reference 2x2", {"loss_gap_to_port_2x2": abs(float(ref["loss"]) - float(w["loss"])),
                            "grad_gap_port_2x2": T._within(T._grads(w, "g"), ref_g),
                            "grad_gap_to_port_unsharded": T._within(ref_g, grads)}, flush=True)
    r = T._spawn("1x2", tmp, steps=False, resume=str(tmp / "ckpt"))
    print("resumed on 1x2", {"tail": r["resume_tail"].tolist(),
                             "uninterrupted": w["full_losses"].tolist(),
                             "gap": float(np.abs(r["resume_tail"]
                                                 - w["full_losses"][2:]).max())}, flush=True)


def collectives(tmp: Path) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.sharding import Sharder
    from repro_torch.train import step as tstep

    init_world("cpu", rank=0, world=1, init_file=str(tmp / "rendezvous"))
    counts = collections.Counter()
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"):
        def counted(*a, _f=getattr(dist, name), _n=name, **k):
            counts[_n] += 1
            return _f(*a, **k)
        setattr(dist, name, counted)
    try:
        qwen = dataclasses.replace(get_arch("qwen2-7b").reduced(), n_layers=4)
        for cfg, micro in ((qwen, 2), (get_arch("tiny-650k"), 1)):
            sharder = Sharder(make_mesh(1, 1, "cpu"), cfg, replicate_params_below=0)
            state = tstep.init_state(cfg, device="cpu", grad_compress_bits=8,
                                     param_dtype=torch.bfloat16)
            step = tstep.make_train_step(cfg, sharder=sharder, grad_compress_bits=8,
                                         microbatches=micro, loss_chunk=32)
            t = torch.randint(0, cfg.vocab_size, (4, 33))
            counts.clear()
            step(state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            print(cfg.name, {"layers": cfg.n_layers, "microbatches": micro, **counts,
                             "total": sum(counts.values())}, flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-gaps", action="store_true")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        if not args.skip_gaps:
            gaps(tmp)
        collectives(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
