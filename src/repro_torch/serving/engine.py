"""Static-batch inference engine: the paper's deployment target (16-bit
activations, k-bit weights) — port of ``repro/serving/engine.py``.

``Engine.generate`` takes a batch of same-length prompts, prefills the KV
caches once, then runs single-token decode steps with greedy or
temperature sampling and per-sequence EOS masking.  cfg.kv_bits < 16 serves
from the packed k-bit cache; an Engine at kv_bits=16 is the bf16-cache
oracle the quantized cache is held against (``kv_oracle_logit_gap``).

PyTorch runs eagerly, so there is nothing to compile: prefill and decode
are plain calls, and the caches are updated in place.  Sampling draws from
a ``torch.Generator``.

Not in this slice: the sharder, telemetry, the step profiler and
construction from a PrecisionPlan.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm

#: stated per-token logit tolerance of a k-bit KV cache vs the bf16-cache
#: oracle (tiny family, float codebook, block 64), as in the reference.
KV_LOGIT_TOL = {8: 0.2, 4: 1.0}


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: float) -> torch.Tensor:
    """Greedy at temperature 0, else a categorical draw (Gumbel-max, as
    jax.random.categorical) at ``temperature``.  Returns int32 [B]."""
    greedy = torch.argmax(logits, dim=-1)
    if temperature <= 0:
        return greedy.to(torch.int32)
    scaled = logits.to(torch.float32) / max(temperature, 1e-6)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


@torch.inference_mode()
def kv_oracle_logit_gap(params, cfg_q, prompts, n_steps: int, *, device=None):
    """Teacher-forced per-token logit gap of cfg_q's k-bit KV cache vs the
    bf16-cache oracle: rolls the bf16-cache model greedily over ``prompts``
    [B, S], replays the same tokens through the k-bit cache, and returns
    (max |logit gap| over all steps including prefill, greedy-agreement
    fraction)."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    cache_len = prompts.shape[1] + n_steps

    def rollout(c, force=None):
        logits, caches = lm.prefill(params, prompts, c, cache_len=cache_len)
        logs = [logits.to(torch.float32)]
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok]
        for t in range(n_steps - 1):
            feed = tok if force is None else force[t]
            logits, caches = lm.decode_step(params, feed, caches, prompts.shape[1] + t, c)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks.append(tok)
            logs.append(logits.to(torch.float32))
        return torch.stack(toks), torch.stack(logs)

    toks16, logs16 = rollout(cfg_q.with_kv_quant(16))
    toksq, logsq = rollout(cfg_q, force=toks16)
    gap = float((logs16 - logsq).abs().max())
    agree = float((toks16 == toksq).to(torch.float32).mean())
    return gap, agree


class Engine:
    def __init__(self, params, cfg, *, max_seq_len: int, eos_id: int | None = None,
                 matmul_mode: str | None = None, device=None):
        if matmul_mode is not None:
            cfg = cfg.with_matmul_mode(matmul_mode)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.eos_id = eos_id

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, *, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts [B, S] int -> tokens [B, <= max_new_tokens] int32."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, S = prompts.shape
        if S + max_new_tokens > self.max_seq_len:
            raise ValueError(f"{S} + {max_new_tokens} tokens exceed the cache budget "
                             f"{self.max_seq_len}")
        logits, caches = lm.prefill(self.params, prompts, self.cfg,
                                    cache_len=self.max_seq_len)
        tok = sample_token(logits, generator, temperature)
        done = (tok == self.eos_id) if self.eos_id is not None \
            else torch.zeros((B,), dtype=torch.bool, device=self.device)
        out = [tok]
        for t in range(1, max_new_tokens):
            logits, caches = lm.decode_step(self.params, tok, caches, S + t - 1, self.cfg)
            tok = sample_token(logits, generator, temperature)
            if self.eos_id is not None:
                tok = torch.where(done, torch.full_like(tok, self.eos_id), tok)
                done = done | (tok == self.eos_id)
            out.append(tok)
            if self.eos_id is not None and bool(done.all()):
                break
        return torch.stack(out, dim=1)


@torch.inference_mode()
def perplexity(params, cfg, tokens, *, batch_size: int = 8, device=None) -> float:
    """Held-out perplexity of (possibly quantized) params — the paper's
    preferred evaluation metric (§4)."""
    dev = resolve_device(device)
    if not isinstance(tokens, torch.Tensor):
        tokens = np.asarray(tokens)
    tokens = torch.as_tensor(tokens, device=dev)
    total, count = 0.0, 0
    for i in range(0, tokens.shape[0], batch_size):
        tb = tokens[i: i + batch_size]
        labels = tb[:, 1:]
        loss = lm.loss_fn(params, tb[:, :-1], labels, cfg,
                          loss_chunk=min(512, tb.shape[1] - 1))
        total += float(loss) * labels.numel()
        count += labels.numel()
    return float(math.exp(total / count))
