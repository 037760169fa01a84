"""Training launcher — port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-2.6m --steps 300 \
        --batch 32 --seq 256 --ckpt-dir artifacts/ckpt_torch/tiny-2.6m [--device cpu]

Trains on CUDA unless ``--device`` says otherwise.  Fault tolerance: with
``--ckpt-dir`` a run resumes from the latest checkpoint there; SIGTERM
triggers a final synchronous save.  ``--grad-compress-bits k`` trains with
blockwise k-bit gradient compression and error feedback.  ``--mesh
pod16x16`` (256 ranks, 16 x 16 ("data", "model")) or ``pod2x16x16`` (512,
"pod" in front) trains on the reference's production mesh, one process a
rank under torchrun (``launch/mesh.init_world``), the state stored FSDP's
way (``models/sharding.py``); a world of another size is refused, naming
the ranks the mesh needs.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.sharding import Sharder
from repro_torch.train import loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "pod16x16", "pod2x16x16"], default="none",
                    help="production meshes need 256/512 devices")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    dev = resolve_device(args.device)
    sharder = None
    if args.mesh != "none":
        multi_pod = args.mesh == "pod2x16x16"
        need = mesh_mod.production_world(multi_pod=multi_pod)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != need:
            raise ValueError(f"--mesh {args.mesh} needs a world of {need} ranks (one a "
                             f"device, under torchrun) but this one has {world}")
        dev = mesh_mod.init_world(dev.type)
        sharder = Sharder(mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                        device=dev.type), cfg)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.2f}M params on {dev}")
    state, history = loop.train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq,
                                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                                seed=args.seed, peak_lr=args.lr,
                                grad_compress_bits=args.grad_compress_bits, sharder=sharder,
                                device=dev)
    if history:
        print(f"done: loss {history[0]:.4f} -> {history[-1]:.4f}")
    else:
        print(f"done: already at step {args.steps} in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
