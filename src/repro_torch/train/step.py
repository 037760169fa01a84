"""Train step assembly: loss -> grads -> AdamW — port of
``repro/train/step.py`` for one device.

Gradients come from ``torch.autograd`` over the port's ``lm.loss_fn`` (the
model computes in bf16 on f32 master weights, as the reference's does).
The dense weights carry no kernel, so no backward kernel is needed.

Not in this slice: the sharder (TP/FSDP specs, head padding) and blockwise
gradient compression with error feedback (ROADMAP queue A11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState


def init_state(cfg, *, seed: int = 0, device=None) -> TrainState:
    """Seeded f32 parameters on ``device`` (CUDA by default) and zero moments."""
    params = lm.init_params(cfg, seed=seed, device=device)
    return TrainState(params=params, opt=adamw.init(params))


def make_train_step(cfg, *, peak_lr: float = 3e-3, warmup: int = 50, total_steps: int = 1000,
                    loss_chunk: int = 512, microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``.  ``microbatches``
    > 1 accumulates f32 gradients over that many slices of the batch, which
    bounds activation memory by one slice's."""

    def grads_of(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten(params, flat)
        b = batch["tokens"].shape[0]
        if microbatches < 1 or b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        loss_sum, acc = 0.0, [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        for tokens, labels in zip(batch["tokens"].chunk(microbatches),
                                  batch["labels"].chunk(microbatches)):
            loss = lm.loss_fn(live, tokens, labels, cfg, loss_chunk=loss_chunk)
            grads = torch.autograd.grad(loss, flat)
            acc = [a + g.to(torch.float32) for a, g in zip(acc, grads)]
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        return loss_sum * inv, unflatten(params, [a * inv for a in acc])

    def train_step(state: TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        lr = adamw.cosine_lr(state.opt.step, peak=peak_lr, warmup=warmup, total=total_steps)
        params, opt, gnorm = adamw.update(state.params, grads, state.opt, lr=lr)
        return TrainState(params=params, opt=opt), {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step

