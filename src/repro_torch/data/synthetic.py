"""Deterministic synthetic language: a Zipf-Markov process — port of
``repro/data/synthetic.py``: the training corpus and the continuous-batching
server's workloads (``serving_workload``, ``two_class_workload`` and the
paged pool's ``shared_prefix_workload``).

A power-law unigram distribution composed with low-rank bigram structure:
language-like enough that tiny LMs learn a nontrivial conditional
distribution and that quantization noise degrades held-out perplexity
smoothly, which is all the paper's scaling-law methodology needs.

``make_transition_logits`` is the reference's numpy code, so the process is
the same one, byte for byte.  Sampling draws from a ``torch.Generator`` on
the process's device: the reference's ``jax.random`` stream cannot be
reproduced, so the two packages draw different token sequences from the
same distribution.  The workloads draw lengths, budgets, arrivals and
classes with numpy in the reference's order, and each prompt from a
generator seeded by (seed, request index).
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


def _prompt(proc: ZipfMarkov, seed: int, i: int, length: int) -> np.ndarray:
    """Request i's prompt: ``length`` tokens from a generator seeded by
    (seed, i) alone, on the host."""
    return proc.sample(generator(seed * 1_000_003 + i, proc.device), 1, length)[0].cpu().numpy()


def serving_workload(vocab: int, n_requests: int, *, prompt_lens=tuple(range(8, 33)),
                     max_new_range=(8, 48), rate: float = 2.0, priorities: int = 1,
                     seed: int = 0, device=None) -> list:
    """A bursty serving trace: mixed-length Zipf-Markov prompts with Poisson
    arrivals (exponential gaps, ``rate`` requests per engine step), decode
    budgets uniform over ``max_new_range`` and, with ``priorities > 1``, a
    uniform priority class in [0, priorities) (0 most urgent).

    Returns dicts {prompt, max_new, arrival_time, priority} sorted by
    arrival; deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    proc = ZipfMarkov(vocab, seed=seed, device=device)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    reqs = []
    for i in range(n_requests):
        L = int(rng.choice(prompt_lens))
        max_new = int(rng.integers(max_new_range[0], max_new_range[1] + 1))
        reqs.append({
            "prompt": _prompt(proc, seed + 17, i, L),
            "max_new": max_new,
            "arrival_time": float(arrivals[i]),
            "priority": int(rng.integers(0, priorities)),
        })
    return reqs


def two_class_workload(vocab: int, n_requests: int, *, hi_frac: float = 0.25,
                       span: float = 24.0, seed: int = 0, device=None) -> list:
    """The SLA scheduler's stress trace: a burst of long low-priority
    requests (class 1: prompts of 24-32 tokens, budgets of 32-48, arriving
    in the first step, so they fill the pool) and a trickle of short
    high-priority ones (class 0: prompts of 8-12, budgets of 4-8, arriving
    uniformly over [2, span) steps, each while the pool is busy).

    Returns dicts {prompt, max_new, arrival_time, priority} sorted by
    arrival; deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    proc = ZipfMarkov(vocab, seed=seed, device=device)
    n_hi = max(1, int(round(hi_frac * n_requests)))
    reqs = []
    for i in range(n_requests - n_hi):
        L = int(rng.integers(24, 33))
        reqs.append({"prompt": _prompt(proc, seed + 29, i, L),
                     "max_new": int(rng.integers(32, 49)),
                     "arrival_time": float(rng.uniform(0.0, 1.0)), "priority": 1})
    for i in range(n_hi):
        L = int(rng.integers(8, 13))
        reqs.append({"prompt": _prompt(proc, seed + 31, i, L),
                     "max_new": int(rng.integers(4, 9)),
                     "arrival_time": float(rng.uniform(2.0, span)), "priority": 0})
    reqs.sort(key=lambda r: r["arrival_time"])
    return reqs


def shared_prefix_workload(vocab: int, n_requests: int, *, n_prefixes: int = 2,
                           prefix_len: int = 24, suffix_len: int = 6, max_new_range=(8, 16),
                           rate: float = 4.0, seed: int = 0, device=None) -> list:
    """A multi-tenant chat-style trace: every prompt is one of
    ``n_prefixes`` shared prefixes (the "system prompt") followed by a short
    private suffix, with Poisson arrivals at ``rate`` requests per engine
    step: the workload the paged pool's copy-on-write prefix sharing is
    for.  A slot pool stores the prefix once a request, the paged pool once
    a prefix.  All prompts have one length (prefix_len + suffix_len), so
    every admission lands in one prefill bucket, which COW keys embed.

    Returns dicts {prompt, max_new, arrival_time, priority, prefix_id}
    sorted by arrival; deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    proc = ZipfMarkov(vocab, seed=seed, device=device)
    L = prefix_len + suffix_len
    prefixes = [_prompt(proc, seed + 41, p, L) for p in range(n_prefixes)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    reqs = []
    for i in range(n_requests):
        p = int(rng.integers(0, n_prefixes))
        # the private suffix overwrites the shared sample's tail, so the
        # first prefix_len tokens stay shared across the group
        prompt = prefixes[p].copy()
        prompt[prefix_len:] = _prompt(proc, seed + 43, i, L - prefix_len)
        reqs.append({
            "prompt": prompt,
            "max_new": int(rng.integers(max_new_range[0], max_new_range[1] + 1)),
            "arrival_time": float(arrivals[i]),
            "priority": 0,
            "prefix_id": p,
        })
    return reqs


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
