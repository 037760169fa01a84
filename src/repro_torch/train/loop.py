"""Training loop on the synthetic corpus — port of ``repro/train/loop.py``
for one device, without checkpointing.

Not in this slice: resume-from-latest, async checkpoints with data state,
the preemption save (``checkpoint/manager.py``, ROADMAP queue A9) and the
straggler watchdog, which watches hosts of a cluster.
"""

from __future__ import annotations

import time

from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.train import step as step_mod


def train(cfg, *, steps: int, batch: int, seq_len: int, seed: int = 0,
          peak_lr: float = 3e-3, log_every: int = 20, log=print, device=None,
          ckpt_dir: str | None = None):
    """Train a (tiny) model on the synthetic corpus on ``device`` (CUDA by
    default); returns (final state, per-step losses)."""
    if ckpt_dir is not None:
        raise NotImplementedError("checkpointing (checkpoint/manager.py) is not ported yet: "
                                  "ROADMAP queue A9")
    dev = resolve_device(device)
    state = step_mod.init_state(cfg, seed=seed, device=dev)
    train_step = step_mod.make_train_step(cfg, peak_lr=peak_lr, total_steps=steps,
                                          loss_chunk=min(512, seq_len))
    data = synthetic.batches(cfg.vocab_size, batch, seq_len, seed=seed, device=dev)
    history = []
    for i, b in zip(range(steps), data):
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if i % log_every == 0 or i == steps - 1:
            log(f"step {i:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        history.append(loss)
    return state, history
