"""Continuous-batching server: slot pool + scheduler + model steps — port of
``repro/serving/server.py`` on the slot pool.

Decode runs as one fixed-shape step over the whole slot pool with a
position a row: busy rows decode their own request at their own position,
idle rows are masked (pos = -1).  Between decode steps the server admits
queued requests into free slots by prefilling each new prompt on its own
(batch 1, padded to a power-of-two bucket) and scattering the resulting KV
rows into the slot, so requests join and leave the decode batch mid-flight
without touching the other rows.

On the card the decode step over the pool is one ``torch.cuda.CUDAGraph``
for each Server, the port's analogue of the reference's compile-once step:
the graph reads the pool's caches, the per-row positions
(``SlotKVCache.pos_vector``), tokens and temperatures from static buffers
and writes the sampled tokens to one; a step is a few small host-to-device
copies and one replay.  Prefill and chunk steps run eagerly.  On the CPU
(``device='cpu'``, the plain path) the decode step is an eager call.

Admission order is SLA-aware (``serving/scheduler.py``): priority classes
drain in per-class FIFO order with anti-starvation aging, and with
``max_preemptions > 0`` an urgent arrival that finds the pool full evicts a
lower-priority victim by spilling its packed cache rows to host memory as
stored and restoring them bit for bit later, so preempted streams are
token-identical to an unpreempted run.  ``prefill_chunk=C`` splits long
prompts into chunks interleaved with decode steps; the committed rows match
a plain prefill's (``attention.prefill_chunk_attention``), so chunking never
changes tokens.  That holds while the bucket fits one of
flash_attention's KV chunks (``attention.KV_CHUNK``) and, on the card,
while every chunk starts at a multiple of ``attention.Q_PIECE``: there C
must be a multiple of it, and a bucket that is not (one capped at a cache
length off that multiple) prefills plainly, as does a bucket past
``KV_CHUNK``.  Prompt-length bucketing is safe because every ported
model is causal full attention: padded positions are masked out of the
cache (``kvcache.scatter_row``).

``telemetry=`` (``serving/telemetry.py``, the no-op by default) turns the
request lifecycle into spans and metrics, timed at the host with a fence
after each dispatch; the steps themselves are the same with it on or off.

Not in this slice: the paged pool (``paged=True``, ROADMAP A6), the mesh
(``sharder=``, A11), construction from a precision plan (A8), the telemetry
quant-health probes (``kv_probe_every``, A7) and the roofline profiler
(A7).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.kv_dequant import kv_spec
from repro_torch.models import attention, lm
from repro_torch.serving.engine import capture_graph, sample_token
from repro_torch.serving.kvcache import SlotKVCache, scatter_row, workspace_to_row
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.telemetry import NOOP


def bucket_len(n: int, *, minimum: int = 8, cap: int | None = None) -> int:
    """Round up to a power of two (at least ``minimum``, at most ``cap``)."""
    b = max(minimum, 1 << max(0, n - 1).bit_length())
    return min(b, cap) if cap is not None else b


class _ChunkState:
    """Host-side progress of one chunked admission: the padded prompt, the
    chunk starts (the last one shifted left so a fixed-size chunk never
    overruns the bucket; overlapped rows rewrite identical values) and the
    dense bf16 workspace the chunks write."""

    def __init__(self, *, req, slot, L, Sb, padded, starts, workspace, t_start):
        self.req = req
        self.slot = slot
        self.L = L
        self.Sb = Sb
        self.padded = padded
        self.starts = starts
        self.workspace = workspace
        self.t_start = t_start
        self.next = 0           # index of the next chunk to run


def _bucketing_safe(cfg) -> bool:
    """Padded prefill is inert only when every mixer is causal full
    attention (SSM states and sliding-window rings would absorb the
    padding)."""
    return not cfg.sliding_window and all(m == "attn" for m, _ in cfg.layer_schedule())


def _fence(t: torch.Tensor) -> None:
    """Wait for the work that produces ``t`` (host-side timing only)."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


class Server:
    """Continuous-batching front end: ``submit()`` requests, ``step()`` the
    engine (or ``run_until_drained()``), receive each request's tokens
    through its callback."""

    def __init__(self, params, cfg, *, num_slots: int, max_seq_len: int,
                 eos_id: int | None = None, seed: int = 0, dtype=torch.bfloat16,
                 matmul_mode: str | None = None, sharder=None, telemetry=NOOP,
                 prefill_chunk: int | None = None, aging_steps: int | None = 64,
                 max_preemptions: int = 0, paged: bool = False, device=None):
        if matmul_mode is not None:
            cfg = cfg.with_matmul_mode(matmul_mode)
        if paged:
            raise NotImplementedError("the paged KV pool (paged=True) is not ported yet: "
                                      "ROADMAP A6, pages")
        if sharder is not None:
            raise NotImplementedError("the Server on a mesh (sharder=) is not ported yet: "
                                      "ROADMAP A11")
        if telemetry.enabled and telemetry.kv_probe_every > 0:
            raise NotImplementedError("the telemetry quant-health probes (kv_probe_every) "
                                      "are not ported yet: ROADMAP A7")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if not _bucketing_safe(cfg) or cfg.n_experts:
                raise ValueError("prefill_chunk needs a bucketing-safe arch (causal full "
                                 "attention, dense FFN)")
        self.device = resolve_device(device)
        # chunk starts at multiples of this (see the module docstring)
        self._chunk_align = attention.Q_PIECE if self.device.type == "cuda" else 1
        if prefill_chunk is not None and prefill_chunk % self._chunk_align:
            raise ValueError(f"on CUDA prefill_chunk must be a multiple of {self._chunk_align}"
                             f" (attention.Q_PIECE), got {prefill_chunk}")
        self.telemetry = telemetry
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.kvq = kv_spec(cfg)   # None = bf16 cache; else packed k-bit
        self.pool = SlotKVCache(cfg, num_slots, max_seq_len, dtype, telemetry=telemetry,
                                device=self.device)
        self.scheduler = Scheduler(eos_id=eos_id, telemetry=telemetry,
                                   aging_steps=aging_steps, max_preemptions=max_preemptions)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._bucketed = _bucketing_safe(cfg)
        self._prefill_chunk = prefill_chunk
        self._cfg16 = cfg.with_kv_quant(16)   # the chunk workspace's dense layout
        self._chunking: dict[int, _ChunkState] = {}   # slot -> progress
        self._spilled: dict[int, dict] = {}           # request id -> spill
        self._cur_tok = np.zeros(num_slots, dtype=np.int64)
        self._temps = np.zeros(num_slots, dtype=np.float32)
        self.steps = 0          # decode steps executed (virtual clock)
        self.tokens_out = 0     # total generated tokens
        # the decode step's static inputs and output (the graph's buffers)
        self._tok = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        self._temps_dev = torch.zeros((num_slots,), dtype=torch.float32, device=self.device)
        self._nxt = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        # captured while the pool is empty: the warm-up call's idle rows only
        # park pos = -1 at a clamped slot of rows no request holds
        self._graph = (capture_graph(self._decode_body, self.device, self._gen)
                       if self.device.type == "cuda" else None)

    # -- the model steps -----------------------------------------------------
    def _decode_body(self) -> None:
        """One decode step over the pool, on the static buffers."""
        logits, _ = lm.decode_step(self.params, self._tok, self.pool.caches,
                                   self.pool._pos_dev, self.cfg)
        self._nxt.copy_(sample_token(logits, self._gen, self._temps_dev))

    def _prefill_into_slot(self, padded: np.ndarray, length: int, slot: int,
                           temperature: float) -> torch.Tensor:
        """Prefill [1, Sb], sample the first token at the true last prompt
        position length - 1 (padded positions are causally downstream) and
        scatter the KV rows into ``slot``."""
        prompt = torch.as_tensor(padded, device=self.device)
        h, caches = lm.backbone_seq(self.params, prompt, self.cfg, write_cache=True,
                                    cache_len=self.pool.cache_len)
        logits = lm.logits_from_hidden(self.params, h[:, length - 1], self.cfg)
        tok = sample_token(logits, self._gen, float(temperature))
        scatter_row(self.pool.caches, caches, slot, length)
        return tok

    # -- API -----------------------------------------------------------------
    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               arrival_time: float = 0.0, priority: int = 0, on_token=None) -> int:
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        # positions [0, L + max_new - 1) are written: the prompt and every
        # generated token but the last, which is returned and never fed back
        if len(prompt) + max_new - 1 > self.pool.cache_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} needs "
                f"{len(prompt) + max_new - 1} cache positions but the "
                f"budget is {self.pool.cache_len}")
        req = Request(prompt=prompt, max_new=max_new, temperature=temperature,
                      priority=priority, arrival_time=arrival_time, on_token=on_token)
        self.scheduler.submit(req)
        tel = self.telemetry
        if tel.enabled:
            req.t_submit = tel.now()
            tel.event("submit", req.t_submit, request_id=req.id, step=self.steps,
                      prompt_len=len(prompt), max_new=max_new, arrival_time=arrival_time,
                      priority=priority)
        return req.id

    def step(self) -> int:
        """Admit arrived requests (preempting a lower-priority victim when
        the pool is full and preemption is on), advance one prefill chunk
        per chunking slot, then run one decode step over the non-chunking
        slots.  Returns the number of tokens produced (first tokens of
        admissions included)."""
        produced = self._admit()
        produced += self._advance_chunks()
        if len(self.scheduler.running) > len(self._chunking):
            produced += self._decode_once()
        self.steps += 1
        return produced

    def run_until_drained(self) -> dict:
        """Step until every submitted request has finished; the virtual
        clock jumps over idle gaps to the next arrival.  Returns
        {request_id: [tokens]}."""
        while not self.scheduler.drained:
            if not self.scheduler.running:
                nxt = self.scheduler.next_arrival()
                if nxt is not None and nxt > self.steps:
                    self.steps = int(np.ceil(nxt))
            self.step()
        return {r.id: list(r.tokens) for r in self.scheduler.finished}

    # -- internals -----------------------------------------------------------
    def _emit(self, req, tok: int) -> None:
        req.tokens.append(tok)
        self.tokens_out += 1
        tel = self.telemetry
        if tel.enabled:
            now = tel.now()
            tel.inc("serve_tokens_total")
            if req.t_first_token is None:
                req.t_first_token = now
                if req.t_submit is not None:
                    tel.observe("serve_ttft_seconds", now - req.t_submit)
                tel.event("token", now, request_id=req.id, step=self.steps, first=True)
            elif req.t_last_token is not None:
                tel.observe("serve_itl_seconds", now - req.t_last_token)
            req.t_last_token = now
        if req.on_token is not None:
            req.on_token(req.id, tok)

    def _retire(self, req, slot: int, reason: str) -> None:
        self.scheduler.retire(slot, self.steps)
        self.pool.free(slot)
        tel = self.telemetry
        if tel.enabled:
            tel.event("retire", tel.now(), request_id=req.id, step=self.steps,
                      n_tokens=len(req.tokens), reason=reason)

    def _after_first(self, req, slot: int, first: int) -> None:
        """Retire a request done at its first token, else join the decode
        batch with it."""
        self._emit(req, first)
        if self.scheduler.should_retire(req):
            self._retire(req, slot, "budget" if len(req.tokens) >= req.max_new else "eos")
        elif self.pool.room(slot) <= 0:
            # a full row must never join the decode batch: its write would
            # clamp into the last stored position
            self._retire(req, slot, "cache_full")
        else:
            self._cur_tok[slot] = first
            self._temps[slot] = req.temperature

    def _admit(self) -> int:
        produced = 0
        tel = self.telemetry
        while True:
            req = self.scheduler.next_admissible(self.steps)
            if req is None:
                break
            resume = req.id in self._spilled
            L = len(req.prompt)
            Sb = bucket_len(L, cap=self.pool.cache_len) if self._bucketed else L
            blocked = False
            while not self.pool.n_free:
                # a full pool: evict a strictly lower-priority victim if
                # preemption is on (mid-chunk slots have no committed rows)
                vslot = self.scheduler.preemption_victim(req, self.steps,
                                                         exclude=self._chunking)
                if vslot is None:
                    blocked = True
                    break
                self._preempt(vslot, req)
            if blocked:
                break
            slot = self.pool.alloc()
            self.scheduler.bind(req, slot, self.steps)
            if resume:
                self._resume(req, slot)
                continue
            if (self._prefill_chunk is not None and L > self._prefill_chunk
                    and Sb <= attention.KV_CHUNK and Sb % self._chunk_align == 0):
                self._start_chunked(req, slot, L, Sb)
                continue
            padded = np.zeros((1, Sb), dtype=np.int64)
            padded[0, :L] = req.prompt
            if tel.enabled:
                t0 = tel.now()
                if req.t_submit is not None:
                    tel.span("queue_wait", req.t_submit, t0, request_id=req.id,
                             step=self.steps, steps=float(self.steps - req.arrival_time))
            tok = self._prefill_into_slot(padded, L, slot, req.temperature)
            self.pool.install_prefill(slot, L)
            if tel.enabled:
                _fence(tok)
                t1 = tel.now()
                tel.observe("serve_prefill_seconds", t1 - t0)
                tel.observe("serve_prefill_pad_frac", (Sb - L) / Sb)
                tel.inc("serve_prefills_total")
                tel.span("prefill", t0, t1, request_id=req.id, step=self.steps, slot=slot,
                         prompt_len=L, padded_len=Sb)
            self._after_first(req, slot, int(tok[0]))
            produced += 1
        return produced

    def _preempt(self, slot: int, by: Request) -> None:
        """Evict the request in ``slot`` for the higher-priority ``by``: copy
        its packed cache rows to host memory as stored, requeue it, free the
        slot.  The restore is bit-exact, so its token stream is the one an
        unpreempted run gives."""
        victim = self.scheduler.running[slot]
        tel = self.telemetry
        t0 = tel.now() if tel.enabled else 0.0
        spill = self.pool.spill_slot(slot)
        spill["cur_tok"] = int(self._cur_tok[slot])
        self._spilled[victim.id] = spill
        self.scheduler.preempt(slot, self.steps)
        self.pool.free(slot)
        if tel.enabled:
            t1 = tel.now()
            tel.event("preempt", t0, request_id=victim.id, step=self.steps, slot=slot,
                      by=by.id, n_tokens=len(victim.tokens))
            tel.span("spill", t0, t1, request_id=victim.id, step=self.steps, slot=slot,
                     bytes_packed=spill["bytes_packed"], bytes_logical=spill["bytes_logical"])

    def _resume(self, req: Request, slot: int) -> None:
        """Write a preempted request's spilled rows back into its new slot;
        it rejoins the decode batch where it left off."""
        spill = self._spilled.pop(req.id)
        tel = self.telemetry
        t0 = tel.now() if tel.enabled else 0.0
        self.pool.restore_slot(slot, spill)
        self._cur_tok[slot] = spill["cur_tok"]
        self._temps[slot] = req.temperature
        if tel.enabled:
            _fence(self.pool.caches[0]["pos"])
            tel.span("restore", t0, tel.now(), request_id=req.id, step=self.steps, slot=slot,
                     bytes_packed=spill["bytes_packed"])

    def _start_chunked(self, req: Request, slot: int, L: int, Sb: int) -> None:
        """Begin a chunked admission: a dense bf16 workspace and fixed-size
        chunks, the last one shifted left to end at the bucket's edge."""
        C = self._prefill_chunk
        tel = self.telemetry
        padded = np.zeros((1, Sb), dtype=np.int64)
        padded[0, :L] = req.prompt
        n_chunks = -(-L // C)
        starts = [i * C for i in range(n_chunks - 1)]
        starts.append(min((n_chunks - 1) * C, Sb - C))
        workspace = lm.init_caches(self._cfg16, 1, Sb, device=self.device)
        t0 = tel.now() if tel.enabled else 0.0
        if tel.enabled and req.t_submit is not None:
            tel.span("queue_wait", req.t_submit, t0, request_id=req.id, step=self.steps,
                     steps=float(self.steps - req.arrival_time))
        self._chunking[slot] = _ChunkState(req=req, slot=slot, L=L, Sb=Sb, padded=padded,
                                           starts=starts, workspace=workspace, t_start=t0)
        # an idle row of the decode batch until commit (next_pos stays -1)
        self._cur_tok[slot] = 0
        self._temps[slot] = req.temperature

    def _advance_chunks(self) -> int:
        """Run one prefill chunk per chunking slot; commit the slots whose
        last chunk just ran."""
        produced = 0
        tel = self.telemetry
        C = self._prefill_chunk
        for slot in list(self._chunking):
            st = self._chunking[slot]
            c0 = st.starts[st.next]
            tokens = torch.as_tensor(st.padded[:, c0:c0 + C], device=self.device)
            if tel.enabled:
                t0 = tel.now()
            h = lm.backbone_chunk(self.params, tokens, st.workspace, c0, self.cfg)
            if tel.enabled:
                _fence(h)
                t1 = tel.now()
                tel.observe("serve_prefill_chunk_seconds", t1 - t0)
                tel.inc("serve_prefill_chunks_total")
                tel.span("prefill_chunk", t0, t1, request_id=st.req.id, step=self.steps,
                         slot=slot, chunk=st.next, chunk_start=c0, chunk_len=C)
            st.next += 1
            if st.next == len(st.starts):
                produced += self._commit_chunked(slot, st, h)
        return produced

    def _commit_chunked(self, slot: int, st: _ChunkState, h: torch.Tensor) -> int:
        """Sample the first token at the true last prompt row and scatter the
        (re-encoded) workspace into ``slot``: the row a plain prefill
        admission would have written."""
        req = st.req
        tel = self.telemetry
        del self._chunking[slot]
        logits = lm.logits_from_hidden(self.params, h[:, st.L - 1 - st.starts[-1]], self.cfg)
        tok = sample_token(logits, self._gen, float(req.temperature))
        cc = workspace_to_row(st.workspace, self.pool.cache_len, self.kvq)
        scatter_row(self.pool.caches, cc, slot, st.L)
        self.pool.install_prefill(slot, st.L)
        if tel.enabled:
            _fence(tok)
            t1 = tel.now()
            tel.observe("serve_prefill_seconds", t1 - st.t_start)
            tel.observe("serve_prefill_pad_frac", (st.Sb - st.L) / st.Sb)
            tel.inc("serve_prefills_total")
            tel.span("prefill", st.t_start, t1, request_id=req.id, step=self.steps, slot=slot,
                     prompt_len=st.L, padded_len=st.Sb, chunks=len(st.starts))
        self._after_first(req, slot, int(tok[0]))
        return 1

    def _decode_once(self) -> int:
        """One decode step over the pool: load the static inputs, replay the
        captured step on the card (an eager call on the CPU), emit a token
        for every decoding row."""
        active = self.pool.active
        self._tok.copy_(torch.from_numpy(np.where(active, self._cur_tok, 0).astype(np.int32)))
        self._temps_dev.copy_(torch.from_numpy(np.where(active, self._temps, 0.0)
                                               .astype(np.float32)))
        self.pool.pos_vector()
        tel = self.telemetry
        if tel.enabled:
            n_active = self.pool.n_active
            t0 = tel.now()
        if self._graph is not None:
            self._graph.replay()
        else:
            self._decode_body()
        nxt = self._nxt.cpu().numpy()
        if tel.enabled:
            t1 = tel.now()
            fill = n_active / self.pool.num_slots
            tel.observe("serve_decode_step_seconds", t1 - t0)
            tel.observe("serve_batch_fill", fill)
            tel.inc("serve_decode_steps_total")
            tel.span("decode_step", t0, t1, step=self.steps, n_active=n_active,
                     batch_fill=fill)
        produced = 0
        for slot, req in list(self.scheduler.running.items()):
            if slot in self._chunking:
                continue    # mid-chunk: a masked idle row, no token yet
            t = int(nxt[slot])
            self._emit(req, t)
            produced += 1
            self.pool.advance(slot)
            if self.scheduler.should_retire(req):
                self._retire(req, slot, "budget" if len(req.tokens) >= req.max_new else "eos")
            elif self.pool.room(slot) <= 0:
                self._retire(req, slot, "cache_full")
            else:
                self._cur_tok[slot] = t
        return produced
