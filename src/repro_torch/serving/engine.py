"""Static-batch inference engine: the paper's deployment target (16-bit
activations, k-bit weights) — port of ``repro/serving/engine.py``.

``Engine.generate`` takes a batch of same-length prompts, prefills the KV
caches once, then runs single-token decode steps with greedy or
temperature sampling and per-sequence EOS masking.  cfg.kv_bits < 16 serves
from the packed k-bit cache; an Engine at kv_bits=16 is the bf16-cache
oracle the quantized cache is held against (``kv_oracle_logit_gap``).

The reference jit-compiles its decode step; the port's analogue is a CUDA
graph.  On the card ``generate`` captures one ``torch.cuda.CUDAGraph`` for
each batch size over the Engine's cache length: the graph holds
``lm.decode_step``, ``sample_token`` and the EOS update, and it reads and
writes static buffers (the token, the position as a device int32 that the
graph itself advances, the temperature a row, the caches, ``done`` and the
output row), so a step is one replay.  The prefill's caches are copied into
the static caches before the first replay.  The graph samples from a
generator of the Engine's own, registered with it; a call that samples
copies its generator's state (the device's default generator when none is
given) into that one before the replays and back after them, so the same
seed draws the same tokens as eager steps would.  The EOS early exit stays
a host check between replays, as in the reference.  If the capture fails,
``generate`` raises: there is no eager fallback on the card.  On the CPU
(the plain path, ``device='cpu'``) prefill and decode are eager calls.

Not in this slice: the sharder, telemetry, the step profiler and
construction from a PrecisionPlan.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import launches
from repro_torch.models import lm

#: stated per-token logit tolerance of a k-bit KV cache vs the bf16-cache
#: oracle (tiny family, float codebook, block 64), as in the reference.
KV_LOGIT_TOL = {8: 0.2, 4: 1.0}


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature) -> torch.Tensor:
    """Greedy at temperature 0, else a categorical draw (Gumbel-max, as
    jax.random.categorical) at ``temperature``: a float, or a tensor of
    per-row temperatures [B] (greedy where <= 0), as the continuous-batching
    server samples its pool.  Returns int32 [B]."""
    greedy = torch.argmax(logits, dim=-1)
    per_row = isinstance(temperature, torch.Tensor)
    if not per_row and temperature <= 0:
        return greedy.to(torch.int32)
    # a float becomes a 0-d tensor: the same division as the per-row form
    # (CUDA multiplies by the reciprocal of a Python scalar instead), so the
    # captured steps, which sample at per-row temperatures, draw the tokens
    # that eager calls at a float temperature draw
    t = (temperature if per_row else
         torch.full((), temperature, dtype=torch.float32, device=logits.device))
    scaled = logits.to(torch.float32) / torch.clamp(t.to(torch.float32), min=1e-6)[..., None]
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    if per_row:
        sampled = torch.where(temperature > 0, sampled, greedy)
    return sampled.to(torch.int32)


class CapturedStep:
    """A body captured as a ``torch.cuda.CUDAGraph`` (``capture_graph``):
    ``replay()`` runs it and adds the kernel launches that it recorded to
    the wrappers' counters (``kernels/launches.py``)."""

    def __init__(self, graph, launched: tuple[int, ...]):
        self.graph = graph
        self.launched = launched

    def replay(self) -> None:
        self.graph.replay()
        launches.add(self.launched)


def capture_graph(body, device: torch.device, generator: torch.Generator | None = None):
    """``body`` captured as a ``CapturedStep``, after one warm-up call on a
    side stream (PyTorch's CUDA-graph recipe); a ``generator`` that the body
    draws from is registered with the graph, and left in the state it had
    before the warm-up.  The warm-up runs the body once on its static
    buffers, so callers load their state after the capture.  Its launches
    count; the recording's do not (it launches nothing), they count at each
    replay.  Raises if the body cannot be captured (a host sync inside it,
    say)."""
    state = generator.get_state() if generator is not None else None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = launches.snapshot()
    with torch.cuda.graph(graph):
        body()
    launched = tuple(a - b for a, b in zip(launches.snapshot(), before))
    launches.add([-n for n in launched])
    if state is not None:
        generator.set_state(state)
    return CapturedStep(graph, launched)


class _DecodeGraph:
    """The Engine's captured step for one batch size: static buffers and
    the step that reads and writes them."""

    def __init__(self, engine: "Engine", batch: int):
        dev, cfg = engine.device, engine.cfg
        self.caches = lm.init_caches(cfg, batch, engine.max_seq_len, device=dev)
        self.tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.temps = torch.zeros((batch,), dtype=torch.float32, device=dev)
        self.done = torch.zeros((batch,), dtype=torch.bool, device=dev)
        self.out = torch.zeros((batch, engine.max_seq_len), dtype=torch.int32, device=dev)
        self.col = torch.zeros((1,), dtype=torch.int64, device=dev)
        eos, gen = engine.eos_id, engine._gen

        def body():
            logits, _ = lm.decode_step(engine.params, self.tok, self.caches, self.pos, cfg)
            nxt = sample_token(logits, gen, self.temps)
            if eos is not None:
                nxt = torch.where(self.done, torch.full_like(nxt, eos), nxt)
                self.done.logical_or_(nxt == eos)
            self.tok.copy_(nxt)
            self.out.index_copy_(1, self.col, nxt[:, None])
            self.col.add_(1)
            self.pos.add_(1)

        self.step = capture_graph(body, dev, gen)

    def load(self, caches, tok: torch.Tensor, done: torch.Tensor, pos: int,
             temperature: float) -> None:
        """The state after prefill into the static buffers (device copies
        and fills only)."""
        for mine, theirs in zip(self.caches, caches):
            for key in mine:
                mine[key].copy_(theirs[key])
        self.tok.copy_(tok)
        self.done.copy_(done)
        self.out[:, 0].copy_(tok)
        self.col.fill_(1)
        self.pos.fill_(pos)
        self.temps.fill_(temperature)


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
        self._graphs: dict[int, _DecodeGraph] = {}   # batch -> captured step
        # the captured steps' generator (CUDA only; see the module docstring)
        self._gen = torch.Generator(self.device) if self.device.type == "cuda" else None

    def _decode_graph(self, batch: int) -> _DecodeGraph:
        """The captured step for ``batch`` rows, captured on first use (CUDA
        only)."""
        if batch not in self._graphs:
            self._graphs[batch] = _DecodeGraph(self, batch)
        return self._graphs[batch]

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, *, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts [B, S] int -> tokens [B, <= max_new_tokens] int32.  On
        CUDA each decode step is one replay of the captured step."""
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
        if self.device.type == "cuda" and max_new_tokens > 1:
            g = self._decode_graph(B)
            g.load(caches, tok, done, S, temperature)
            del caches
            source = None
            if temperature > 0:   # draw on from the caller's generator state
                index = self.device.index
                source = generator if generator is not None else torch.cuda.default_generators[
                    torch.cuda.current_device() if index is None else index]
                self._gen.set_state(source.get_state())
            n = 1
            while n < max_new_tokens:
                g.step.replay()
                n += 1
                if self.eos_id is not None and bool(g.done.all()):
                    break
            if source is not None:
                source.set_state(self._gen.get_state())
            return g.out[:, :n].clone()
        out = [tok]
        for t in range(1, max_new_tokens):   # the plain path (CPU), eager
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
