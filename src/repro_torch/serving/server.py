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
``KV_CHUNK``.  Prompt-length bucketing is safe where every layer is
causal full attention: padded positions are masked out of the cache
(``kvcache.scatter_row``).  An arch with a sliding window (h2o-danube-3,
gemma2's local layers) keeps ring caches, which padding would overwrite,
and one with SSM layers (mamba2, jamba) a recurrent state, which padding
would advance, so it prefills every prompt at its exact length, and
``paged=True`` and ``prefill_chunk`` refuse it (``_bucketing_safe``, the
reference's rule).  An SSM prompt's length must then divide into the
arch's SSD chunks (``ssm.ssd_chunked``), as in the reference.
Mixture-of-experts archs bucket too: their bucket-padded prefills pass the
router pad mask (``lm.backbone_seq(pad_mask=)``, ``models/moe.py``), so
padding claims no expert capacity and real tokens keep and drop what they
would at the exact length when that runs one dispatch group (the
reference's rule); ``prefill_chunk`` refuses them (chunk-local capacity).

``paged=True`` swaps the slot pool for the page-table pool
(``serving/pages.py``): KV storage is one pool of ``n_pages`` pages of
``page_size`` positions, each row a page table, and requests whose prompts
share a prefix store its full pages once (copy-on-write).  The decode step
reads and writes through the table, which the captured step reads from a
static device buffer (refreshed by one copy before a step, only when the
host table changed), so one graph serves every table.  Paged greedy tokens
are the slot pool's at every kv_bits.  Preemption spills only a request's
private pages and keeps its shared prefix resident; admission reserves a
request's worst case in pages, and a request that could never fit the pool
is refused at ``submit``.

``telemetry=`` (``serving/telemetry.py``, the no-op by default) turns the
request lifecycle into spans and metrics, timed at the host with a fence
after each dispatch; the steps themselves are the same with it on or off.
With ``Telemetry(kv_probe_every=N)`` and a packed cache, every Nth
admission's prompt also runs a separate kv16 prefill whose K/V rows are
round-tripped through the cache's encode and the plain dequant
(``kv_append_qerr_rms``/``_max``, ``kv_probe_rows_total``); the served
caches, steps and tokens are untouched.

``Telemetry(profiler=StepProfiler())`` (serving/profiler.py) costs each
program once under the reference's names — ``prefill[Sb]``,
``prefill_paged[Sb]``, ``prefill_chunk[Sb]``, ``chunk_commit[Sb]`` and
``decode_step`` (a replay of the pool's graph on the card) — on clones of
the pool's caches or of the chunk workspace and with the generator's state
put back, before the dispatch's timed window, and attributes the measured
times against the H100's roofline; the served steps, the captured graph
and the tokens are the same with it on or off.

``plan=`` (a precision/plan.py PrecisionPlan) quantizes a RAW tree at
construction, on the Server's device, before the pool is allocated and its
step captured, recording the load-time quantization health first.

``sharder=`` (``models/sharding.Sharder``) serves the slot pool on a mesh
of ranks, every rank running the same Server on its slices: the params cut
by ``shard_params``, the pool placed by ``shard_caches`` (rows over the
data axes, slots sequence-sharded), each admission's prefill run with the
sharder's ``constrain`` and ``q_pad`` and written into the windows (and
SSM heads and channels) this rank holds (``Sharder.local_row``), and the
pool step reading through ``decode_attn_fn`` with per-slot positions, its
SSM and MoE layers placed by the same ``constrain``; on the card the step
is one graph, its collectives inside.  Dense, MoE (bucketed with the
router pad mask), SSM (exact-length prefills) and hybrid decoders take a
sharder alike.  As in the reference, ``paged`` and ``prefill_chunk`` refuse
a sharder.  Preemption on a mesh: every rank runs the same scheduler, so
every rank spills the same victim in the same order; the spill gathers the
victim's whole row onto every rank (``SlotKVCache.spill_slot``), so it
resumes in any free slot, whichever data rank holds it.  The step profiler
on a mesh costs each rank's own slice of each program (its FLOPs and bytes
are per rank, its ``collective_bytes`` the rank's payload); the costing run
issues the program's collectives, and every rank makes it at the same point.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.kv_dequant import kv_spec
from repro_torch.models import attention, blocks, lm
from repro_torch.models.quantize import quantize_tree
from repro_torch.models.sharding import check_decode_capability
from repro_torch.serving.engine import (
    capture_graph,
    clone_caches,
    fence,
    profiler_session,
    sample_token,
)
from repro_torch.serving.kvcache import SlotKVCache, scatter_row, workspace_to_row
from repro_torch.serving.pages import PagedKVPool, paged_decode_attn_fn, scatter_pages
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.telemetry import (
    NOOP,
    kv_roundtrip_error,
    record_quant_health,
    record_tree_bits,
)


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
    attention: SSM states and sliding-window rings would absorb the
    padding (the reference's rule, checked mixer by mixer).  MoE archs are
    safe with the router pad mask the Server threads into their prefills."""
    return all(m.startswith("attn") and blocks.mixer_window(m, cfg) == 0
               for m, _ in cfg.layer_schedule())


class Server:
    """Continuous-batching front end: ``submit()`` requests, ``step()`` the
    engine (or ``run_until_drained()``), receive each request's tokens
    through its callback."""

    def __init__(self, params, cfg, *, num_slots: int, max_seq_len: int,
                 eos_id: int | None = None, seed: int = 0, dtype=torch.bfloat16,
                 plan=None, matmul_mode: str | None = None, sharder=None, telemetry=NOOP,
                 prefill_chunk: int | None = None, aging_steps: int | None = 64,
                 max_preemptions: int = 0, paged: bool = False, page_size: int = 16,
                 n_pages: int | None = None, device=None):
        blocks.check_dense(cfg)
        if matmul_mode is not None:
            cfg = cfg.with_matmul_mode(matmul_mode)
        check_decode_capability(cfg, sharder,
                                caller="the continuous-batching Server (serving/server.py)")
        if paged:
            if not _bucketing_safe(cfg):
                raise ValueError("paged serving requires causal full attention in every "
                                 "layer: SSM states and sliding-window rings do not "
                                 "decompose into position-indexed pages")
            if prefill_chunk is not None:
                raise ValueError("prefill_chunk and paged are mutually exclusive (the chunk "
                                 "workspace commits whole slot rows)")
            if sharder is not None:
                raise ValueError("paged serving is single-host for now (the pool itself "
                                 "places on a mesh via cache_spec_tree(paged=True)); drop "
                                 "one of paged / sharder")
        elif n_pages is not None:
            raise ValueError("n_pages requires paged=True")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if not _bucketing_safe(cfg) or cfg.n_experts:
                raise ValueError("prefill_chunk needs a bucketing-safe arch (causal full "
                                 "attention, dense FFN)")
            if sharder is not None:
                raise ValueError("prefill_chunk is single-device only (the chunk workspace "
                                 "and commit path are unsharded); drop one of prefill_chunk "
                                 "/ sharder")
        self.device = resolve_device(device)
        # chunk starts at multiples of this (see the module docstring)
        self._chunk_align = attention.Q_PIECE if self.device.type == "cuda" else 1
        if prefill_chunk is not None and prefill_chunk % self._chunk_align:
            raise ValueError(f"on CUDA prefill_chunk must be a multiple of {self._chunk_align}"
                             f" (attention.Q_PIECE), got {prefill_chunk}")
        self.telemetry = telemetry
        if plan is not None:
            # load-time quantization health: per-matrix bits + blockwise
            # qerr, measured on the raw tree before it is consumed
            record_quant_health(telemetry, params, cfg, plan=plan)
            params = quantize_tree(params, cfg, plan=plan, device=self.device)
        else:
            record_tree_bits(telemetry, params)
        self.sharder = sharder
        self._kw = {}   # the prefills' placement on a mesh
        self._constrain = blocks.NO_CONSTRAIN   # the decode step's SSM and MoE layers'
        if sharder is not None:
            # extra decode room so full-attention caches divide the grid
            max_seq_len = sharder.pad_cache_len(max_seq_len)
            params = sharder.shard_params(params)
            self._kw = dict(constrain=sharder.constrain, q_pad=sharder.head_pad())
            self._constrain = sharder.constrain
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.kvq = kv_spec(cfg)   # None = bf16 cache; else packed k-bit
        # append-quantize health probe (telemetry.kv_probe_every > 0 and a
        # packed cache): a separate kv16 prefill of the admitted prompt
        self._probe = telemetry.enabled and telemetry.kv_probe_every > 0 \
            and self.kvq is not None
        self._n_admitted = 0
        self._kv_err_sum, self._kv_err_n = 0.0, 0
        self._paged = paged
        if paged:
            self.pool = PagedKVPool(cfg, num_slots, max_seq_len, dtype, page_size=page_size,
                                    n_pages=n_pages, telemetry=telemetry, device=self.device)
            self._decode_attn = paged_decode_attn_fn(self.pool._page_map_dev, page_size)
        else:
            self.pool = SlotKVCache(cfg, num_slots, max_seq_len, dtype, sharder=sharder,
                                    telemetry=telemetry, device=self.device)
            self._decode_attn = (blocks.local_decode_attn if sharder is None
                                 else sharder.decode_attn_fn(num_slots, max_seq_len))
        self.scheduler = Scheduler(eos_id=eos_id, telemetry=telemetry,
                                   aging_steps=aging_steps, max_preemptions=max_preemptions)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._bucketed = _bucketing_safe(cfg)
        # MoE archs bucket safely only with the router pad mask; exact-length
        # prefills keep none, so their grouped dispatch stays the Engine's
        self._use_pad_mask = bool(cfg.n_experts) and self._bucketed
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
        # park pos = -1 at a clamped slot of rows no request holds (paged:
        # at the trash page)
        self._graph = (capture_graph(self._decode_body, self.device, self._gen)
                       if self.device.type == "cuda" else None)
        # optional roofline attribution (serving/profiler.py): a private
        # session labelled with this server's quant config; host-side only,
        # the steps above are the same with it on
        self._prof, self._annot = profiler_session(telemetry, cfg)

    def _cost(self, name: str, program, written) -> None:
        """Cost ``program(clone)`` once under ``name``, where ``written`` is
        the cache tree it writes in place (the pool's caches or a chunk
        workspace) and ``clone`` a copy of it; the generator's state is put
        back after."""
        if self._prof is None or name in self._prof.costs:
            return
        state = self._gen.get_state()
        try:
            self._prof.ensure_costed(name, program, (clone_caches(written),))
        finally:
            self._gen.set_state(state)

    # -- the model steps -----------------------------------------------------
    def _decode_body(self) -> None:
        """One decode step over the pool, on the static buffers."""
        self._nxt.copy_(self._decode_program(self.pool.caches))

    def _decode_program(self, caches) -> torch.Tensor:
        """The pool's decode step over ``caches``: the sampled tokens."""
        logits, _ = lm.decode_step(self.params, self._tok, caches, self.pool._pos_dev,
                                   self.cfg, decode_attn=self._decode_attn,
                                   constrain=self._constrain)
        return sample_token(logits, self._gen, self._temps_dev)

    def _pad_mask(self, prompt: torch.Tensor, length: int):
        """The router pad mask of a [1, Sb] prefill (MoE archs), else None."""
        if not self._use_pad_mask:
            return None
        return torch.arange(prompt.shape[1], device=self.device)[None, :] < length

    def _prefill_into_pages(self, pool_caches, padded: np.ndarray, length: int,
                            pages: np.ndarray, write_mask: np.ndarray,
                            temperature: float) -> torch.Tensor:
        """The paged twin of ``_prefill_into_slot``: prefill [1, Sb] at its
        own length, sample the first token at length - 1 and write the
        request's own prompt pages (``write_mask``) of ``pool_caches``,
        leaving the COW-shared prefix and the bucket's padding unwritten."""
        prompt = torch.as_tensor(padded, device=self.device)
        h, caches = lm.backbone_seq(self.params, prompt, self.cfg, write_cache=True,
                                    pad_mask=self._pad_mask(prompt, length))
        logits = lm.logits_from_hidden(self.params, h[:, length - 1], self.cfg)
        tok = sample_token(logits, self._gen, float(temperature))
        scatter_pages(pool_caches, caches, pages, write_mask, length, self.pool.page_size)
        return tok

    def _prefill_into_slot(self, pool_caches, padded: np.ndarray, length: int, slot: int,
                           temperature: float) -> torch.Tensor:
        """Prefill [1, Sb], sample the first token at the true last prompt
        position length - 1 (padded positions are causally downstream) and
        scatter the KV rows into ``slot`` of ``pool_caches``."""
        prompt = torch.as_tensor(padded, device=self.device)
        h, caches = lm.backbone_seq(self.params, prompt, self.cfg, write_cache=True,
                                    cache_len=self.pool.cache_len,
                                    pad_mask=self._pad_mask(prompt, length), **self._kw)
        logits = lm.logits_from_hidden(self.params, h[:, length - 1], self.cfg)
        tok = sample_token(logits, self._gen, float(temperature))
        if self.sharder is not None:   # this rank's windows of the slot, if it holds it
            slot, caches = self.sharder.local_row(caches, slot, self.pool.num_slots)
        if slot is not None:
            scatter_row(pool_caches, caches, slot, length)
        return tok

    def _probe_kv_error(self, padded: np.ndarray, length: int) -> None:
        """Measure the append-quantize roundtrip error on this prompt's
        actual K/V rows (a kv16 prefill -> encode_rows -> plain dequant)
        and fold it into the cumulative gauges."""
        prompt = torch.as_tensor(padded, device=self.device)
        _, caches = lm.backbone_seq(self.params, prompt, self._cfg16, write_cache=True,
                                    **self._kw)
        tel = self.telemetry
        for cache in caches:
            for key in sorted(cache):
                if key not in ("k", "v"):
                    continue
                leaf = cache[key]
                rows = leaf[:, 0, : min(length, leaf.shape[2])]
                rows = rows.reshape(-1, rows.shape[-2] * rows.shape[-1])
                err = kv_roundtrip_error(rows, self.kvq)
                self._kv_err_sum += err
                self._kv_err_n += 1
                tel.inc("kv_probe_rows_total", rows.shape[0])
                g = tel.registry.gauge("kv_append_qerr_max")
                if err > g.value:
                    g.set(err)
        tel.set_gauge("kv_append_qerr_rms", self._kv_err_sum / max(self._kv_err_n, 1))

    def _admitted(self, padded: np.ndarray, length: int) -> None:
        """Count a finished admission; probe every kv_probe_every-th."""
        self._n_admitted += 1
        if self._probe and (self._n_admitted - 1) % self.telemetry.kv_probe_every == 0:
            self._probe_kv_error(padded, length)

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
        if self._paged:
            need = self.pool.pages_needed(len(prompt), max_new)
            if need > self.pool.allocator.n_usable:
                raise ValueError(f"request needs {need} pages worst-case but the pool holds "
                                 f"{self.pool.allocator.n_usable}: it could never be admitted "
                                 f"(raise n_pages or lower max_new)")
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
        n_freed = self.pool.free(slot)
        tel = self.telemetry
        if tel.enabled:
            now = tel.now()
            if self._paged:
                # before the retire event, which closes the request's lifecycle
                tel.event("page_release", now, request_id=req.id, step=self.steps,
                          n_pages=n_freed, reason=reason)
            tel.event("retire", now, request_id=req.id, step=self.steps,
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
            if self._paged:
                # a bucket of whole pages: full prompt pages tile the padded
                # length (and the bucket joins the COW key)
                Sb = bucket_len(L, minimum=max(8, self.pool.page_size), cap=self.pool.cache_len)
            else:
                Sb = bucket_len(L, cap=self.pool.cache_len) if self._bucketed else L
            blocked = False
            while not self._fits(req, resume, Sb):
                # a full pool (no row, or not enough pages): evict a strictly
                # lower-priority victim if preemption is on (mid-chunk slots
                # have no committed rows); each eviction frees a row and its
                # private pages, so the loop ends when victims run out
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
            if self._paged:
                n_shared, n_new, pages, wmask = self.pool.admit_pages(slot, req.id, req.prompt,
                                                                      req.max_new, Sb)
                if tel.enabled:
                    tel.event("page_alloc", tel.now(), request_id=req.id, step=self.steps,
                              slot=slot, n_pages=n_new, n_shared=n_shared)
            if self._paged:
                pf_name = f"prefill_paged[{Sb}]"
                program = lambda pool: self._prefill_into_pages(  # noqa: E731
                    pool, padded, L, pages, wmask, req.temperature)
            else:
                pf_name = f"prefill[{Sb}]"
                program = lambda pool: self._prefill_into_slot(  # noqa: E731
                    pool, padded, L, slot, req.temperature)
            # costed BEFORE t0, so the extra run never pollutes the timed window
            self._cost(pf_name, program, self.pool.caches)
            if tel.enabled:
                t0 = tel.now()
                if req.t_submit is not None:
                    tel.span("queue_wait", req.t_submit, t0, request_id=req.id,
                             step=self.steps, steps=float(self.steps - req.arrival_time))
            with self._annot(pf_name):
                tok = program(self.pool.caches)
            self.pool.install_prefill(slot, L)
            if self._paged:
                # publish the full prompt pages before anything can preempt
                # this slot (a spill retains sealed pages only)
                self.pool.seal_slot(slot)
            if tel.enabled:
                fence(tok)
                t1 = tel.now()
                if self._prof is not None:
                    self._prof.observe(pf_name, t1 - t0)
                tel.observe("serve_prefill_seconds", t1 - t0)
                tel.observe("serve_prefill_pad_frac", (Sb - L) / Sb)
                tel.inc("serve_prefills_total")
                tel.span("prefill", t0, t1, request_id=req.id, step=self.steps, slot=slot,
                         prompt_len=L, padded_len=Sb)
                self._admitted(padded, L)
            self._after_first(req, slot, int(tok[0]))
            produced += 1
        return produced

    def _fits(self, req: Request, resume: bool, Sb: int) -> bool:
        """A free row and, paged, the pages this admission (or resume)
        needs."""
        if not self.pool.n_free:
            return False
        if not self._paged:
            return True
        if resume:
            return self.pool.can_resume_pages(self._spilled[req.id]["n_private"])
        return self.pool.can_admit_pages(req.prompt, req.max_new, Sb)

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
            if self._paged:
                tel.event("page_release", t0, request_id=victim.id, step=self.steps,
                          n_pages=spill["n_private"], reason="preempt")
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
            fence(next(iter(self.pool.caches[0].values())))
            t1 = tel.now()
            if self._paged:
                tel.event("page_alloc", t0, request_id=req.id, step=self.steps, slot=slot,
                          n_pages=spill["n_private"], n_shared=spill["n_retained"])
            tel.span("restore", t0, t1, request_id=req.id, step=self.steps, slot=slot,
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
            ck_name = f"prefill_chunk[{st.Sb}]"
            self._cost(ck_name, lambda ws: lm.backbone_chunk(self.params, tokens, ws, c0,
                                                             self.cfg), st.workspace)
            if tel.enabled:
                t0 = tel.now()
            with self._annot(ck_name):
                h = lm.backbone_chunk(self.params, tokens, st.workspace, c0, self.cfg)
            if tel.enabled:
                fence(h)
                t1 = tel.now()
                if self._prof is not None:
                    self._prof.observe(ck_name, t1 - t0)
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

        def commit(pool_caches):
            logits = lm.logits_from_hidden(self.params, h[:, st.L - 1 - st.starts[-1]],
                                           self.cfg)
            tok = sample_token(logits, self._gen, float(req.temperature))
            cc = workspace_to_row(st.workspace, self.pool.cache_len, self.kvq)
            scatter_row(pool_caches, cc, slot, st.L)
            return tok

        cm_name = f"chunk_commit[{st.Sb}]"
        self._cost(cm_name, commit, self.pool.caches)
        t0c = tel.now() if tel.enabled else 0.0
        with self._annot(cm_name):
            tok = commit(self.pool.caches)
        self.pool.install_prefill(slot, st.L)
        if tel.enabled:
            fence(tok)
            t1 = tel.now()
            if self._prof is not None:
                self._prof.observe(cm_name, t1 - t0c)
            tel.observe("serve_prefill_seconds", t1 - st.t_start)
            tel.observe("serve_prefill_pad_frac", (st.Sb - st.L) / st.Sb)
            tel.inc("serve_prefills_total")
            tel.span("prefill", st.t_start, t1, request_id=req.id, step=self.steps, slot=slot,
                     prompt_len=st.L, padded_len=st.Sb, chunks=len(st.starts))
            self._admitted(st.padded, st.L)
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
        if self._paged:
            self.pool.page_map_vector()
        tel = self.telemetry
        self._cost("decode_step", self._decode_program, self.pool.caches)
        if tel.enabled:
            n_active = self.pool.n_active
            t0 = tel.now()
        with self._annot("decode_step"):
            if self._graph is not None:
                self._graph.replay()
            else:
                self._decode_body()
        nxt = self._nxt.cpu().numpy()
        if tel.enabled:
            t1 = tel.now()
            if self._prof is not None:
                self._prof.observe("decode_step", t1 - t0)
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
