"""Deterministic synthetic language: a Zipf-Markov process — port of
``repro/data/synthetic.py`` (the training corpus; the serving workloads
come with the continuous-batching slice).

A power-law unigram distribution composed with low-rank bigram structure:
language-like enough that tiny LMs learn a nontrivial conditional
distribution and that quantization noise degrades held-out perplexity
smoothly, which is all the paper's scaling-law methodology needs.

``make_transition_logits`` is the reference's numpy code, so the process is
the same one, byte for byte.  Sampling draws from a ``torch.Generator`` on
the process's device: the reference's ``jax.random`` stream cannot be
reproduced, so the two packages draw different token sequences from the
same distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def make_transition_logits(vocab: int, rank: int = 16, seed: int = 0) -> np.ndarray:
    """Low-rank bigram logits: T[i, j] = zipf_j + u_i . v_j (numpy)."""
    rng = np.random.default_rng(seed)
    zipf = -1.2 * np.log(np.arange(1, vocab + 1))
    u = rng.normal(size=(vocab, rank)) / np.sqrt(rank)
    v = rng.normal(size=(vocab, rank))
    logits = zipf[None, :] + 2.0 * (u @ v.T)
    return logits.astype(np.float32)


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class ZipfMarkov:
    def __init__(self, vocab: int, rank: int = 16, seed: int = 0, *, device=None):
        self.vocab = vocab
        self.device = resolve_device(device)
        self.logits = torch.from_numpy(make_transition_logits(vocab, rank, seed)).to(self.device)
        self.probs = torch.softmax(self.logits, dim=-1)
        # per-row CDFs in f64, ending at exactly 1.0, for inverse-CDF draws
        cdf = torch.cumsum(self.probs.to(torch.float64), dim=-1)
        self._cdf = (cdf / cdf[:, -1:]).contiguous()

    def sample(self, gen: torch.Generator, batch: int, seq_len: int) -> torch.Tensor:
        """[batch, seq_len] int32 token sequences: the first token from row 0
        of the transition matrix, each next one from its predecessor's row
        (inverse-CDF draws from one block of uniforms)."""
        u = torch.rand((seq_len, batch, 1), generator=gen, dtype=torch.float64,
                       device=self.device)
        tok = torch.searchsorted(self._cdf[0].expand(batch, -1).contiguous(), u[0],
                                 right=True)[:, 0]
        out = [tok]
        for t in range(1, seq_len):
            tok = torch.searchsorted(self._cdf[tok], u[t], right=True)[:, 0]
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32)

    def entropy_floor(self) -> float:
        """Mean conditional entropy (nats) — the best achievable loss."""
        p = self.probs
        h_cond = -torch.sum(p * torch.log(p + 1e-20), dim=-1)
        # stationary distribution approximated by unigram of the chain
        pi = self.probs[0]
        for _ in range(8):
            pi = pi @ p
        return float(torch.sum(pi * h_cond))


def batches(vocab: int, batch: int, seq_len: int, *, seed: int = 0, start_step: int = 0,
            device=None):
    """Infinite deterministic batch iterator on ``device``; resumable via
    ``start_step``: step i's batch is drawn from a generator seeded by
    (seed, i) alone."""
    proc = ZipfMarkov(vocab, seed=seed, device=device)
    step = start_step
    while True:
        toks = proc.sample(generator((seed + 1) * 1_000_003 + step, proc.device),
                           batch, seq_len + 1)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:], "step": step}
        step += 1
