"""Degradation metrics for precision planning — port of
``repro/precision/metrics.py``.

The planner's probe metric is teacher-forced logit KL vs the 16-bit
model on synthetic batches: deterministic (no free-running token
matching, which flips on near-ties), cheap (one forward per candidate),
and the paper's preferred quality axis up to a monotone transform
(perplexity and KL are both expectations over next-token distributions).

``probe_tokens`` draws from the port's ``ZipfMarkov`` with a seeded
``torch.Generator``: the same process as the reference's, not the same
stream (``data/synthetic.py``), so a comparison of the two packages passes
one batch of tokens across.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import ZipfMarkov, generator
from repro_torch.models import lm
from repro_torch.tree import leaves


def probe_tokens(cfg, *, n_seqs: int = 4, seq_len: int = 64, seed: int = 7,
                 device=None) -> torch.Tensor:
    """Synthetic Zipf-Markov probe batch [n_seqs, seq_len] int32 on
    ``device`` (CUDA by default): the corpus the tiny family is trained on;
    for random-init registry archs it is simply a stream with realistic
    marginals.  The process keeps a vocab x vocab transition matrix (92 GB
    of f32 at Qwen2-7B's 152,064 tokens): for a large vocabulary pass a cfg
    whose ``vocab_size`` is a prefix of the ids."""
    proc = ZipfMarkov(cfg.vocab_size, device=device)
    return proc.sample(generator(seed, proc.device), n_seqs, seq_len)


def _forward_logits(params, toks, cfg) -> torch.Tensor:
    h, _ = lm.backbone_seq(params, toks, cfg)
    return lm.logits_from_hidden(params, h, cfg).to(torch.float32)


@torch.inference_mode()
def teacher_forced_kl(params_ref, params_q, cfg, toks) -> float:
    """Mean KL(p_ref || p_q) over every position of ``toks`` [B, S] (a
    tensor or an array), in f32 on the device the parameters are on."""
    dev = leaves(params_ref)[0].device
    if not isinstance(toks, torch.Tensor):
        toks = torch.tensor(np.asarray(toks))
    toks = toks.to(dev)
    lr = _forward_logits(params_ref, toks, cfg)
    lq = _forward_logits(params_q, toks, cfg)
    kl = torch.softmax(lr, dim=-1) * (torch.log_softmax(lr, -1) - torch.log_softmax(lq, -1))
    return float(torch.mean(torch.sum(kl, dim=-1)))
