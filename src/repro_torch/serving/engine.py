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

Passing ``plan=`` (a precision/plan.py PrecisionPlan) quantizes a RAW tree
at construction, on the Engine's device — the mixed-precision serving
entry point.  ``telemetry=`` (serving/telemetry.py, the no-op by default)
records the load-time quantization health, and the prefill's and each
decode step's times, spans and counters, timed at the host with a fence
after each dispatch (a replay on the card); the captured step is the same
with it on or off.  A ``Telemetry(profiler=StepProfiler())`` also costs
``prefill[BxS]`` and ``decode_step[B]`` once each (serving/profiler.py:
the prefill on its real prompts, the step on clones of the caches, both
before their timed windows and outside any capture) and attributes their
measured times against the H100's roofline.

``sharder=`` (``models/sharding.Sharder``) serves on a mesh of ranks, each
running the same Engine on its own slices: the cache budget is padded to a
multiple of the mesh size (``pad_cache_len``), the params are cut to this
rank's slices (``shard_params``; a tree placed already is taken as it is),
the prefill runs with the sharder's ``constrain`` and ``q_pad`` and its
caches are cut to this rank's windows and heads (``_place_caches``), and
the decode step reads them through ``decode_attn_fn``, its SSM and MoE
layers placed by the same ``constrain`` (dense, MoE, SSM and hybrid
decoders alike).  On the card the sharded step is captured as one graph
like the unsharded one, its collectives (NCCL) inside; the capture's eager
warm-up call on its side stream uses every communicator first.  The step
profiler runs on a mesh too: each rank costs its own slice of each program
(FLOPs and bytes per rank, ``collective_bytes`` its payload), every rank at
the same point, since the costing run issues the program's collectives.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import launches
from repro_torch.models import blocks, lm
from repro_torch.models.quantize import quantize_tree
from repro_torch.models.sharding import check_decode_capability
from repro_torch.serving.profiler import null_annotation
from repro_torch.serving.telemetry import NOOP, record_quant_health, record_tree_bits

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


def fence(t: torch.Tensor) -> None:
    """Wait for the work that produces ``t`` (host-side timing only)."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def profiler_session(telemetry, cfg):
    """(the step profiler's session for a serving instance or None, the
    annotation its dispatch sites wrap), as the reference opens them:
    labelled with the instance's kv_bits and matmul_mode."""
    prof = getattr(telemetry, "profiler", None)
    if not telemetry.enabled or prof is None:
        return None, null_annotation
    session = prof.session(telemetry.registry, kv_bits=str(cfg.kv_bits),
                           matmul_mode=cfg.matmul_mode)
    return session, session.annotation


def clone_caches(caches):
    """A copy of a cache tree (a list of dicts of tensors) to cost a
    program that writes the caches in place on."""
    return [{k: v.clone() for k, v in c.items()} for c in caches]


class CapturedStep:
    """A body captured as a ``torch.cuda.CUDAGraph`` (``capture_graph``):
    ``replay()`` runs it and adds the kernel launches that it recorded to
    the wrappers' counters (``kernels/launches.py``).  A step captured with
    ``debug=True`` keeps its graph's node list, which ``dump_dot`` writes."""

    def __init__(self, graph, launched: tuple[int, ...], debug: bool = False):
        self.graph = graph
        self.launched = launched
        self.debug = debug

    def replay(self) -> None:
        self.graph.replay()
        launches.add(self.launched)

    def dump_dot(self, path) -> None:
        """Write the captured graph's nodes as Graphviz DOT text to ``path``
        (``cudaGraphDebugDotPrint``, verbose: every node's type and
        parameters, a kernel's function name among them).  Needs a step
        captured with ``debug=True``.  Replays are not affected."""
        if not self.debug:
            raise RuntimeError("dump_dot needs a step captured with capture_graph(debug=True)")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # PyTorch warns at every debug dump
            self.graph.debug_dump(str(path))


def capture_graph(body, device: torch.device, generator: torch.Generator | None = None,
                  *, debug: bool = False):
    """``body`` captured as a ``CapturedStep``, after one warm-up call on a
    side stream (PyTorch's CUDA-graph recipe); a ``generator`` that the body
    draws from is registered with the graph, and left in the state it had
    before the warm-up.  The warm-up runs the body once on its static
    buffers, so callers load their state after the capture.  Its launches
    count; the recording's do not (it launches nothing), they count at each
    replay.  ``debug=True`` keeps the graph's node list for
    ``CapturedStep.dump_dot`` (``analysis/audit.py`` reads it).  Raises if
    the body cannot be captured (a host sync inside it, say).  The warm-up
    also makes each collective communicator the body uses (a mesh's NCCL)
    before the capture."""
    state = generator.get_state() if generator is not None else None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    # debug: keep this graph's node list past instantiation (keep_graph),
    # which the dump reads.  Not CUDAGraph.enable_debug_mode(): it is
    # process-wide, and every later graph would keep its nodes too
    graph = torch.cuda.CUDAGraph(keep_graph=True) if debug else torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = launches.snapshot()
    with torch.cuda.graph(graph):
        body()
    if debug:
        graph.instantiate()
    launched = tuple(a - b for a, b in zip(launches.snapshot(), before))
    launches.add([-n for n in launched])
    if state is not None:
        generator.set_state(state)
    return CapturedStep(graph, launched, debug)


class _DecodeGraph:
    """The Engine's captured step for one batch size: static buffers and
    the step that reads and writes them."""

    def __init__(self, engine: "Engine", batch: int):
        dev, cfg = engine.device, engine.cfg
        self.caches = engine._place_caches(
            lm.init_caches(cfg, batch, engine.max_seq_len, device=dev), batch)
        self.tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.temps = torch.zeros((batch,), dtype=torch.float32, device=dev)
        self.done = torch.zeros((batch,), dtype=torch.bool, device=dev)
        self.out = torch.zeros((batch, engine.max_seq_len), dtype=torch.int32, device=dev)
        self.col = torch.zeros((1,), dtype=torch.int64, device=dev)
        eos, gen = engine.eos_id, engine._gen
        decode_attn = engine._decode_attn(batch)

        def body():
            logits, _ = lm.decode_step(engine.params, self.tok, self.caches, self.pos, cfg,
                                       decode_attn=decode_attn, constrain=engine.constrain)
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
def kv_oracle_logit_gap(params, cfg_q, prompts, n_steps: int, *, device=None, sharder=None):
    """Teacher-forced per-token logit gap of cfg_q's k-bit KV cache vs the
    bf16-cache oracle: rolls the bf16-cache model greedily over ``prompts``
    [B, S], replays the same tokens through the k-bit cache, and returns
    (max |logit gap| over all steps including prefill, greedy-agreement
    fraction).  With a ``sharder`` the k-bit replay runs sharded (the
    whole ``params`` cut to this rank's slices, the sequence-sharded
    decode), held against the same unsharded bf16 oracle."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    cache_len = prompts.shape[1] + n_steps
    B = prompts.shape[0]
    if sharder is not None:
        cache_len = sharder.pad_cache_len(cache_len)

    def rollout(c, force=None, s=None):
        p, kw, step_kw = params, {}, {}
        if s is not None:
            p = s.shard_params(params)
            kw = dict(constrain=s.constrain, q_pad=s.head_pad())
            step_kw = dict(constrain=s.constrain, decode_attn=s.decode_attn_fn(B, cache_len))
        logits, caches = lm.prefill(p, prompts, c, cache_len=cache_len, **kw)
        if s is not None:
            caches = s.shard_caches(caches, B)
        logs = [logits.to(torch.float32)]
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok]
        for t in range(n_steps - 1):
            feed = tok if force is None else force[t]
            logits, caches = lm.decode_step(p, feed, caches, prompts.shape[1] + t, c,
                                            **step_kw)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks.append(tok)
            logs.append(logits.to(torch.float32))
        return torch.stack(toks), torch.stack(logs)

    toks16, logs16 = rollout(cfg_q.with_kv_quant(16))
    toksq, logsq = rollout(cfg_q, force=toks16, s=sharder)
    gap = float((logs16 - logsq).abs().max())
    agree = float((toks16 == toksq).to(torch.float32).mean())
    return gap, agree


class Engine:
    def __init__(self, params, cfg, *, max_seq_len: int, sharder=None,
                 eos_id: int | None = None, plan=None, matmul_mode: str | None = None,
                 telemetry=NOOP, device=None):
        blocks.check_dense(cfg)
        if matmul_mode is not None:
            cfg = cfg.with_matmul_mode(matmul_mode)
        check_decode_capability(cfg, sharder, caller="the static Engine (serving/engine.py)")
        self.device = resolve_device(device)
        self.telemetry = telemetry
        if plan is not None:
            # load-time quantization health: per-matrix bits + blockwise
            # qerr, measured on the raw tree before it is consumed
            record_quant_health(telemetry, params, cfg, plan=plan)
            params = quantize_tree(params, cfg, plan=plan, device=self.device)
        else:
            record_tree_bits(telemetry, params)
        if sharder is not None:
            # extra decode room so full-attention caches divide the grid
            max_seq_len = sharder.pad_cache_len(max_seq_len)
            params = sharder.shard_params(params)
        self.params = params
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.eos_id = eos_id
        self.sharder = sharder
        # the placement of the SSM and MoE layers (prefill and decode)
        self.constrain = blocks.NO_CONSTRAIN if sharder is None else sharder.constrain
        self._attn: dict = {}                        # batch -> decode_attn
        self._graphs: dict[int, _DecodeGraph] = {}   # batch -> captured step
        # the captured steps' generator (CUDA only; see the module docstring)
        self._gen = torch.Generator(self.device) if self.device.type == "cuda" else None
        # optional roofline attribution (serving/profiler.py): host-side only,
        # the captured step is the same graph with it on or off
        self._prof, self._annot = profiler_session(telemetry, cfg)

    def _decode_graph(self, batch: int) -> _DecodeGraph:
        """The captured step for ``batch`` rows, captured on first use (CUDA
        only)."""
        if batch not in self._graphs:
            self._graphs[batch] = _DecodeGraph(self, batch)
        return self._graphs[batch]

    def _decode_attn(self, batch: int):
        """The decode read for ``batch`` rows (the sharder's, made once)."""
        if self.sharder is None:
            return blocks.local_decode_attn
        if batch not in self._attn:
            self._attn[batch] = self.sharder.decode_attn_fn(batch, self.max_seq_len)
        return self._attn[batch]

    def _place_caches(self, caches, batch: int):
        """The caches cut to this rank's windows (as they are without a
        sharder)."""
        return caches if self.sharder is None else self.sharder.shard_caches(caches, batch)

    def _prefill(self, prompts: torch.Tensor):
        kw = {}
        if self.sharder is not None:
            kw = dict(constrain=self.sharder.constrain, q_pad=self.sharder.head_pad())
        logits, caches = lm.prefill(self.params, prompts, self.cfg,
                                    cache_len=self.max_seq_len, **kw)
        return logits, self._place_caches(caches, prompts.shape[0])

    def _cost_step(self, name: str, tok, caches, pos: int, temperature: float, done) -> None:
        """Cost ``decode_step[B]`` (the step, its sampling and the EOS
        update, as the reference's step program) on clones of the caches,
        drawing from a generator of its own."""
        if name in self._prof.costs:
            return
        clones, gen = clone_caches(caches), torch.Generator(self.device)

        def step():
            logits, _ = lm.decode_step(self.params, tok, clones, pos, self.cfg,
                                       decode_attn=self._decode_attn(tok.shape[0]),
                                       constrain=self.constrain)
            nxt = sample_token(logits, gen, temperature)
            if self.eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, self.eos_id), nxt)
            return nxt

        self._prof.ensure_costed(name, step, ())

    def _record_step(self, t: int, t0: float, t_prev: float, batch: int, name: str) -> float:
        """Decode step ``t`` (program ``name``) into the telemetry: it ran
        from ``t0`` to now, the previous token came at ``t_prev``.  Returns
        now."""
        tel = self.telemetry
        t1 = tel.now()
        if self._prof is not None:
            self._prof.observe(name, t1 - t0)
        tel.observe("serve_decode_step_seconds", t1 - t0)
        tel.observe("serve_itl_seconds", t1 - t_prev)
        tel.inc("serve_decode_steps_total")
        tel.inc("serve_tokens_total", batch)
        tel.span("decode_step", t0, t1, step=t, n_active=batch, batch_fill=1.0)
        return t1

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
        tel, prof = self.telemetry, self._prof
        pf_name, ds_name = f"prefill[{B}x{S}]", f"decode_step[{B}]"
        if prof is not None:
            # costed BEFORE t_start, so the extra run never pollutes the
            # timed window
            prof.ensure_costed(pf_name, self._prefill, (prompts,))
        if tel.enabled:
            t_start = tel.now()
        with self._annot(pf_name):
            logits, caches = self._prefill(prompts)
        tok = sample_token(logits, generator, temperature)
        if tel.enabled:
            fence(tok)
            t_tok = tel.now()
            if prof is not None:
                prof.observe(pf_name, t_tok - t_start)
            tel.observe("serve_prefill_seconds", t_tok - t_start)
            tel.observe("serve_ttft_seconds", t_tok - t_start)
            tel.inc("serve_prefills_total")
            tel.inc("serve_tokens_total", B)
            tel.span("prefill", t_start, t_tok, step=0, slot=-1, prompt_len=S, padded_len=S)
        done = (tok == self.eos_id) if self.eos_id is not None \
            else torch.zeros((B,), dtype=torch.bool, device=self.device)
        if prof is not None and max_new_tokens > 1:
            self._cost_step(ds_name, tok, caches, S, temperature, done)
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
                if tel.enabled:
                    t0 = tel.now()
                with self._annot(ds_name):
                    g.step.replay()
                if tel.enabled:
                    fence(g.tok)
                    t_tok = self._record_step(n, t0, t_tok, B, ds_name)
                n += 1
                if self.eos_id is not None and bool(g.done.all()):
                    break
            if source is not None:
                source.set_state(self._gen.get_state())
            return g.out[:, :n].clone()
        out = [tok]
        for t in range(1, max_new_tokens):   # the plain path (CPU), eager
            if tel.enabled:
                t0 = tel.now()
            with self._annot(ds_name):
                logits, caches = lm.decode_step(self.params, tok, caches, S + t - 1, self.cfg,
                                                decode_attn=self._decode_attn(B),
                                                constrain=self.constrain)
                tok = sample_token(logits, generator, temperature)
                if self.eos_id is not None:
                    tok = torch.where(done, torch.full_like(tok, self.eos_id), tok)
                    done = done | (tok == self.eos_id)
            if tel.enabled:
                fence(tok)
                t_tok = self._record_step(t, t0, t_tok, B, ds_name)
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
