#!/usr/bin/env python3
"""The paper ladder's training with and without remat, on one device.

    python3 scripts/train_remat_cost.py [--device cpu] [--steps N]

Trains each model of ``paper.common.TRAIN_RECIPE`` (tiny-160k to tiny-10m,
the recipe's batch and sequence length, ``--steps`` steps each, default the
recipe's) through ``train.loop.train``, once with ``lm.loss_fn``'s default
``remat=True`` (each period recomputed in the backward, as the reference's
``jax.checkpoint``) and once with ``remat=False``, in the order off, on,
on, off after a 2-step warm-up of each, and prints each model's seconds
and last loss for both (the same seed and data: the losses are equal, only
the time differs).  TF32 is off, as in chip_smoke.py.  On the card it also prints the card's name and power
limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.paper.common import TRAIN_RECIPE
    from repro_torch.train import loop

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss_fn = lm.loss_fn

    def run(remat: bool, steps=None) -> dict:
        lm.loss_fn = functools.partial(loss_fn, remat=remat)
        out = {}
        try:
            for name, recipe in TRAIN_RECIPE.items():
                recipe = dict(recipe, steps=steps or args.steps or recipe["steps"])
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, hist = loop.train(get_arch(name), log=lambda *_: None, device=dev, **recipe)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                out[name] = {"seconds": time.perf_counter() - t0, "loss_last": hist[-1]}
        finally:
            lm.loss_fn = loss_fn
        return out

    run(False, steps=2), run(True, steps=2)   # warm-up: first calls, library handles
    runs = [("off", run(False)), ("on", run(True)), ("on", run(True)), ("off", run(False))]
    for name in TRAIN_RECIPE:
        print(json.dumps({"model": name, **{f"{k}_{i}_s": r[name]["seconds"]
                                            for i, (k, r) in enumerate(runs)},
                          "loss_last": [r[name]["loss_last"] for _, r in runs]}), flush=True)
    total = {f"{k}_{i}": sum(v["seconds"] for v in r.values()) for i, (k, r) in enumerate(runs)}
    print(json.dumps({"ladder_train_s": total, "device": str(dev)}), flush=True)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
