"""AdamW with a cosine schedule and global-norm clipping — port of
``repro/optim/adamw.py``; on a mesh the state is stored FSDP's way
(``models/sharding.TrainPlacement``) and only the norm needs the mesh.

The same math as the reference: f32 moments, bias correction, decoupled
weight decay on every leaf of two or more dimensions (none on vectors,
``adamw.py:60``; a stacked norm scale [n_layers, D] has two and is decayed,
as there), and clipping by the global norm of all gradients.  ``update`` is
functional like the reference's: it returns new parameter and moment trees.
The step count and the learning rate stay tensors on the parameters'
device, so a training step does not wait on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: dict
    v: dict


def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=tree_map(torch.clone, zeros))


def cosine_lr(step, *, peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak``, then a cosine down to ``floor * peak``;
    ``step`` is an int tensor (or an int), the result an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * (step + 1) / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, peak * cos)


def global_norm(grads, *, placement=None):
    """The norm of all gradients.  With ``placement``
    (``models/sharding.TrainPlacement``) ``grads`` are this rank's slices
    and the norm is the whole tree's: each leaf's sum of squares
    all-reduced over the axes it is split over, a leaf stored whole counted
    once, the leaves added in the same order."""
    sums = [torch.sum(g.to(torch.float32) ** 2) for g in leaves(grads)]
    if placement is not None:
        sums = placement.shard_sums(sums)
    return torch.sqrt(sum(sums))


def clip_by_global_norm(grads, max_norm: float):
    """Gradients scaled to a global norm of at most ``max_norm``, and that
    norm (``global_norm``)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1, max_grad_norm: float = 1.0,
           placement=None, inplace: bool = False):
    """One AdamW step -> (new params, new state, global grad norm).  On a
    mesh (``placement``) every tree holds this rank's slices, updated
    element by element as the whole leaves would be (a slice keeps its
    leaf's ``ndim``, which decides the decay); only the norm is global.
    ``inplace`` writes the new params and moments into the given ones (the
    same numbers), so a step holds one copy of them, as the reference's
    loop donates its state to the jitted step."""
    gnorm = global_norm(grads, placement=placement)
    scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = (g * scale).to(torch.float32)   # clip_by_global_norm's scaling, a leaf at a time
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        decay = weight_decay if p.ndim >= 2 else 0.0  # no decay on vectors
        new_p = (p.to(torch.float32) - lr * (u + decay * p.to(torch.float32))).to(p.dtype)
        if inplace:
            return p.copy_(new_p), m.copy_(m2), v.copy_(v2)
        return new_p, m2, v2

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), gnorm
