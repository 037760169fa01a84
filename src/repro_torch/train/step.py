"""Train step assembly: loss -> grads (-> optional blockwise gradient
compression with error feedback) -> AdamW — port of ``repro/train/step.py``.

Gradients come from ``torch.autograd`` over the port's ``lm.loss_fn`` (the
model computes in bf16 on f32 master weights, as the reference's does, or
on bf16 masters with ``init_state(param_dtype=torch.bfloat16)``; the AdamW
moments stay f32), or over ``seq2seq.loss_fn`` for an encoder-decoder
config, whose batch adds "frames" [B, S, D] to "tokens" and "labels".  The
dense weights carry no kernel, so no backward kernel is needed.
``grad_compress_bits`` k > 0 sends the gradients through
``optim/grad_compress.compress_tree`` before AdamW (on the card one
flat-encode launch a leaf of 1,024 elements or more), its error feedback
carried in ``TrainState.err``.

On a ("data", "model") mesh (``sharder=``, ``models/sharding.py``) a
decoder (dense, MoE, SSM or hybrid) or the encoder-decoder trains as the
reference's sharded step does: the state is stored
FSDP's way (``TrainPlacement``: each rank holds its slice of every dense
leaf, of its moments and of its error), each microbatch's rows split over
the data axes, weights gathered where used and their gradients
reduce-scattered back, the loss and the gradient norm global.  A whole
state handed to the step is cut to this rank's slices first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import lm, seq2seq
from repro_torch.models.blocks import NO_CONSTRAIN
from repro_torch.optim import adamw, grad_compress
from repro_torch.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    err: dict | None = None   # gradient-compression error feedback


def init_state(cfg, *, seed: int = 0, device=None, grad_compress_bits: int = 0,
               param_dtype=None) -> TrainState:
    """Seeded parameters on ``device`` (CUDA by default), zero f32 moments
    and, with ``grad_compress_bits``, zero f32 compression errors.
    ``param_dtype`` (torch.bfloat16) stores the f32 leaves in that dtype:
    bf16 master weights, as the reference's ``init_state(param_dtype=)``;
    the weights are drawn in f32 and rounded once, as there."""
    if cfg.encoder_decoder:
        params = seq2seq.init_params(cfg, seed=seed, device=device)
    else:
        params = lm.init_params(cfg, seed=seed, device=device,
                                dtype=param_dtype or torch.float32)
    if param_dtype is not None:
        params = tree_map(lambda p: p.to(param_dtype) if p.dtype == torch.float32 else p,
                          params)
    err = grad_compress.init_error_state(params) if grad_compress_bits else None
    return TrainState(params=params, opt=adamw.init(params), err=err)


def make_train_step(cfg, *, sharder=None, peak_lr: float = 3e-3, warmup: int = 50,
                    total_steps: int = 1000, grad_compress_bits: int = 0,
                    loss_chunk: int = 512, microbatches: int = 1, donate: bool = False):
    """``train_step(state, batch) -> (state, metrics)``.  ``microbatches``
    > 1 accumulates f32 gradients over that many slices of the batch, which
    bounds activation memory by one slice's: microbatch i holds rows [i·B/m,
    (i+1)·B/m) of the global batch, as the reference's ``split``, and on a
    mesh each data rank takes its share of those.  ``sharder``: a
    ``models/sharding.Sharder`` on a mesh (module docstring); every rank
    passes the same global batch.  ``donate``: the step writes the new
    params, moments and errors into the state it is given (the same
    numbers), as the reference's loop donates its state to the jitted step,
    so a step holds one copy of the state (Qwen2-7B's 14 bytes a parameter
    with bf16 masters and compression).  ``train_step.grads(params,
    batch)`` is (the global loss, this rank's reduced gradients in leaves
    order)."""
    placement = None
    if sharder is not None and sharder.mesh is not None:
        placement = sharder.train_placement()
    view = placement.sharder if placement is not None else None
    constrain = view.constrain if view is not None else NO_CONSTRAIN
    q_pad = view.head_pad() if view is not None else None
    d_idx, d_n = view.coord(view.dp_axes) if view is not None else (0, 1)

    def loss_of(params, mb):
        if cfg.encoder_decoder:
            return seq2seq.loss_fn(params, mb["frames"], mb["tokens"], mb["labels"], cfg,
                                   constrain=constrain, q_pad=q_pad)
        return lm.loss_fn(params, mb["tokens"], mb["labels"], cfg, constrain=constrain,
                          q_pad=q_pad, loss_chunk=loss_chunk)

    def grads_of(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = placement.live(flat) if placement is not None else unflatten(params, flat)
        b = batch["tokens"].shape[0]
        # an encoder-decoder batch that does not divide the data ranks stays
        # whole on each (the reference's _batch_sharding): every data rank
        # takes the whole microbatch, and the global sums count it d_n times
        # over, so the loss is its mean and the summed gradients its own
        whole = cfg.encoder_decoder and microbatches >= 1 and b % microbatches == 0 \
            and b % (microbatches * d_n) != 0
        if microbatches < 1 or (b % (microbatches * d_n) and not whole):
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches "
                             f"over {d_n} data ranks")
        mb = b // microbatches
        share = mb if whole else b // (microbatches * d_n)
        keys = ("frames", "tokens", "labels") if cfg.encoder_decoder else ("tokens", "labels")
        loss_sum, acc = 0.0, [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        for i in range(microbatches):
            lo = i * mb + (0 if whole else d_idx * share)
            loss = loss_of(live, {k: batch[k][lo:lo + share] for k in keys})
            grads = torch.autograd.grad(loss, flat)
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
            del grads
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        for a in acc:
            a.mul_(inv)
        if placement is not None:
            acc = placement.reduce_grads(acc)
        return loss_sum * inv, acc

    def train_step(state: TrainState, batch):
        if placement is not None:
            state = placement.cut_state(state)
        loss, flat = grads_of(state.params, batch)
        grads, err = unflatten(state.params, flat), state.err
        del flat
        if grad_compress_bits:
            grads, err = grad_compress.compress_tree(grads, err, bits=grad_compress_bits,
                                                     placement=placement, inplace=donate)
        lr = adamw.cosine_lr(state.opt.step, peak=peak_lr, warmup=warmup, total=total_steps)
        params, opt, gnorm = adamw.update(state.params, grads, state.opt, lr=lr,
                                          placement=placement, inplace=donate)
        return (TrainState(params=params, opt=opt, err=err),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    train_step.grads = grads_of
    train_step.placement = placement
    return train_step
