"""Train step assembly: loss -> grads (-> optional blockwise gradient
compression with error feedback) -> AdamW — port of ``repro/train/step.py``
for one device.

Gradients come from ``torch.autograd`` over the port's ``lm.loss_fn`` (the
model computes in bf16 on f32 master weights, as the reference's does), or
over ``seq2seq.loss_fn`` for an encoder-decoder config, whose batch adds
"frames" [B, S, D] to "tokens" and "labels".  The dense weights carry no
kernel, so no backward kernel is needed.  ``grad_compress_bits`` k > 0
sends the gradients through ``optim/grad_compress.compress_tree`` before
AdamW (on the card one flat-encode launch a leaf of 1,024 elements or
more), its error feedback carried in ``TrainState.err``.

Not in this slice: the sharder (FSDP storage, TP over the train step;
ROADMAP A11.2; serving on a mesh is ``models/sharding.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import lm, seq2seq
from repro_torch.optim import adamw, grad_compress
from repro_torch.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    err: dict | None = None   # gradient-compression error feedback


def init_state(cfg, *, seed: int = 0, device=None, grad_compress_bits: int = 0) -> TrainState:
    """Seeded f32 parameters on ``device`` (CUDA by default), zero moments
    and, with ``grad_compress_bits``, zero f32 compression errors."""
    init = seq2seq.init_params if cfg.encoder_decoder else lm.init_params
    params = init(cfg, seed=seed, device=device)
    err = grad_compress.init_error_state(params) if grad_compress_bits else None
    return TrainState(params=params, opt=adamw.init(params), err=err)


def make_train_step(cfg, *, peak_lr: float = 3e-3, warmup: int = 50, total_steps: int = 1000,
                    grad_compress_bits: int = 0, loss_chunk: int = 512,
                    microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``.  ``microbatches``
    > 1 accumulates f32 gradients over that many slices of the batch, which
    bounds activation memory by one slice's."""

    def loss_of(params, mb):
        if cfg.encoder_decoder:
            return seq2seq.loss_fn(params, mb["frames"], mb["tokens"], mb["labels"], cfg)
        return lm.loss_fn(params, mb["tokens"], mb["labels"], cfg, loss_chunk=loss_chunk)

    def grads_of(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten(params, flat)
        b = batch["tokens"].shape[0]
        if microbatches < 1 or b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        loss_sum, acc = 0.0, [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        keys = ("frames", "tokens", "labels") if cfg.encoder_decoder else ("tokens", "labels")
        for parts in zip(*(batch[k].chunk(microbatches) for k in keys)):
            loss = loss_of(live, dict(zip(keys, parts)))
            grads = torch.autograd.grad(loss, flat)
            acc = [a + g.to(torch.float32) for a, g in zip(acc, grads)]
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        return loss_sum * inv, unflatten(params, [a * inv for a in acc])

    def train_step(state: TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        err = state.err
        if grad_compress_bits:
            grads, err = grad_compress.compress_tree(grads, err, bits=grad_compress_bits)
        lr = adamw.cosine_lr(state.opt.step, peak=peak_lr, warmup=warmup, total=total_steps)
        params, opt, gnorm = adamw.update(state.params, grads, state.opt, lr=lr)
        return (TrainState(params=params, opt=opt, err=err),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return train_step

