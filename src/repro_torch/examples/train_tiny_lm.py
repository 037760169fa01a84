"""End-to-end training driver with the fault-tolerance story — port of the
reference's ``examples/train_tiny_lm.py``: checkpoints, a kill-and-resume,
blockwise gradient compression with error feedback, the straggler log.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm [--device cpu]

Phase 1 trains to ``--resume-at`` steps with a checkpoint every
``--ckpt-every``; phase 2, as a restarted process would, calls the loop
again to ``--steps``, and it resumes from the checkpoint.  Both compress
the gradients to 8 bits.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.train import loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-650k")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--resume-at", type=int, default=80)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--ckpt-dir", default="artifacts/example_ckpt")
    ap.add_argument("--grad-compress-bits", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.2f}M params")
    kw = dict(batch=args.batch, seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, log_every=20,
              grad_compress_bits=args.grad_compress_bits,   # blockwise-quantized gradients
              device=dev)

    # phase 1: train with async checkpointing
    _, hist1 = loop.train(cfg, steps=args.resume_at, **kw)
    # phase 2: a restart — the loop resumes from the last checkpoint
    print("\n-- simulated restart (a new process would do exactly this) --")
    state, hist2 = loop.train(cfg, steps=args.steps, **kw)
    losses = hist1 + hist2
    if losses:
        print(f"\nresumed seamlessly; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"\nalready at step {args.steps} in {args.ckpt_dir}")
    return {"state": state, "phase1": hist1, "phase2": hist2}


if __name__ == "__main__":
    main()
