"""Layer-2 captured-graph auditor for the serving steps — the counterpart of
``repro/analysis/audit.py``.

The AST rules (:mod:`repro_torch.analysis.rules`) see only source; this
module audits what the card actually captured.  The reference re-lowers
every serving jit and asserts on the HLO text; the port's counterpart of a
jitted program is a body captured as a CUDA graph
(``serving/engine.capture_graph``: the Engine's decode step a batch size,
the Server's pool step), so the auditor builds the real Engine and Servers,
captures their steps with ``debug=True``, drives a workload (a forced
preemption included, so the eager spill, restore and page wipe run),
dumps each graph as DOT text (``CapturedStep.dump_dot``,
``cudaGraphDebugDotPrint``) and asserts on the graph itself:

* **no_host_nodes** (the reference's ``no_host_callbacks``) — the graph
  holds no host node and no memcpy to or from host memory.  A captured
  host copy is a value frozen at capture and read from a host address at
  every replay.  (PyTorch refuses a pageable host copy under capture; a
  pinned one is captured, and this check is what catches it.)
* **no_host_syncs** — while a body is being captured, ``_capture_guard``
  records every ``.item/.cpu/.tolist/.numpy/__int__/__float__/__bool__/
  __index__`` of a CUDA tensor; there are none.
* **in_place** (the reference's ``donation``) — every buffer a captured
  body reads or writes (the Engine's static buffers and caches; the
  Server's ``_tok``, ``_temps_dev``, ``_nxt``, the pool's caches, positions
  and page table) keeps the ``data_ptr`` it had at capture after the whole
  workload, and 50 replays do not grow ``torch.cuda.memory_allocated()``.
  The eager spill, restore and page wipe write the pool's own storage, with
  peak memory growing by less than one slot's rows: no silent full-pool
  copy.
* **kernel_route** (the reference's ``fused_fence``) — for each counter in
  ``kernels/launches.py``, the graph's kernel nodes of that hand-written
  kernel equal the launches its recording counted
  (``CapturedStep.launched``); a 4-bit fused config holds one GEMV node for
  each quantized matrix.
* **recapture** (the reference's ``recompile``) — across the paged sweep
  (admissions, retires, a forced preemption, page remaps) each Server
  captures exactly once, and the Engine once for each batch size.

Without a card the graph checks cannot run, and the audit raises unless
the caller asks for the CPU (``device="cpu"``); then it runs ``in_place``
over the eager paths and counts zero captures, and says that the graph
checks were not run.  No graph check passes without a graph.

``audit_generate`` runs the graph checks on any Engine's one capture, a
sharded one's (MoE, SSM and hybrid decoders on a mesh, NCCL inside the
graph) included: chip_smoke's phase 3n audits those.

Run: ``PYTHONPATH=src python -m repro_torch.analysis.audit [--kv-bits 16 8 4]
[--arch tiny-160k] [--full qwen2-7b] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import launches

#: where the CLI writes the graphs' DOT files (git-ignored)
DOT_DIR = Path(__file__).resolve().parents[3] / "build" / "audit"
#: replays over which the captured step must not allocate
MEMORY_REPLAYS = 50

# ---------------------------------------------------------------------------
# DOT parsing (pure text — unit-testable without a card)

_NODE_RE = re.compile(r'^"(?P<id>[^"]+)"\[(?P<attrs>[^\n]*?)label="(?P<label>.*?)"\];\s*$',
                      re.M | re.S)
_TYPE_RE = re.compile(r"\{\s*([A-Z_]+)")
_KERNEL_RE = re.compile(r"\{ID \| \d+ \(topoId: \d+\) \| (.*?)\\<\\<\\<")
_KIND_RE = re.compile(r"\{kind \| (\w+) \(([^)]*)\)\}")


@dataclass(frozen=True)
class GraphNode:
    """One node of a captured graph's DOT dump."""

    id: str
    type: str  # KERNEL, MEMCPY, MEMSET, HOST, EMPTY, EVENT_RECORD, ...
    kernel: str | None = None  # the function's (mangled) name, kernel nodes
    kind: str | None = None  # memcpy direction: "DtoD", "HtoD", "DtoH", ...
    kind_text: str | None = None  # its long form: "HOST PINNED to DEVICE"

    @property
    def touches_host(self) -> bool:
        """A host node, or a memcpy to or from host memory."""
        if self.type == "HOST":
            return True
        if self.type == "MEMCPY":
            return "H" in (self.kind or "") or "HOST" in (self.kind_text or "").upper()
        return False


def parse_dot(text: str) -> list:
    """The nodes of ``cudaGraphDebugDotPrint``'s verbose output (every
    subgraph's, flattened): their type, a kernel node's function name and a
    memcpy node's direction."""
    nodes = []
    for m in _NODE_RE.finditer(text):
        label = m.group("label")
        t = _TYPE_RE.match(label)
        ntype = t.group(1) if t else "UNKNOWN"
        kernel = kind = kind_text = None
        if ntype == "KERNEL":
            k = _KERNEL_RE.search(label)
            kernel = k.group(1) if k else None
        elif ntype == "MEMCPY":
            k = _KIND_RE.search(label)
            if k:
                kind, kind_text = k.group(1), k.group(2)
        nodes.append(GraphNode(m.group("id"), ntype, kernel, kind, kind_text))
    return nodes


def kernel_base_name(name: str) -> str:
    """A kernel's name without its template arguments, parameters and
    anonymous namespaces: the Itanium-mangled
    ``_ZN2at6native29vectorized_elementwise_kernelILi4E...`` gives
    ``at::native::vectorized_elementwise_kernel``, a csrc kernel
    (``_ZN55_GLOBAL__N__..._kv_decode_attention_cu_...26kv_decode_attention_
    kernelILi4E...``) its own name; a name that is not mangled (an
    ``extern "C"`` kernel) comes back as it is."""
    if not name.startswith("_Z"):
        return name
    s, parts = name[2:], []
    if s.startswith("L"):
        s = s[1:]
    nested = s.startswith("N")
    if nested:
        s = s[1:]
        while s and s[0] in "rVK":
            s = s[1:]
    while s:
        if s.startswith("St"):
            parts.append("std")
            s = s[2:]
            continue
        m = re.match(r"\d+", s)
        if m is None:
            break
        n, start = int(m.group()), len(m.group())
        parts.append(s[start:start + n])
        s = s[start + n:]
        if not nested:
            break
    parts = [p for p in parts if not p.startswith("_GLOBAL__N")]
    return "::".join(parts) if parts else name


_GEMV_TC = ("qgemv_tc_kernel", "qgemv_tc_run_kernel")
_GEMV_TC_ARGS = re.compile(r"qgemv_tc(?:_run)?_kernelI((?:L[a-z]n?\d+E)+)E")


def _experts(name: str) -> bool:
    """Whether a tensor-core GEMV instantiation is the expert-batched one:
    its last template argument (``EXPERTS``, csrc/qgemv_sm90.cu) is true."""
    m = _GEMV_TC_ARGS.search(name)
    return bool(m) and m.group(1).endswith("Lb1E")


def _is(*bases):
    return lambda base, name: base in bases


#: counter (``launches.names()``) -> the kernel nodes a launch of its
#: wrapper records: one node a launch (the prefill GEMM's x tiles and
#: split-K sums are helpers of its launch, not counted)
KERNEL_NODES = {
    "qmatmul_gemv.launches":
        lambda base, name: (base in _GEMV_TC and not _experts(name)) or base == "qgemv_kernel",
    "qmatmul_gemv_tc.launches": lambda base, name: base in _GEMV_TC and not _experts(name),
    "qmatmul_gemv_simt.launches": _is("qgemv_kernel"),
    "qmatmul_gemm.launches": _is("qgemm_sm90_kernel", "qgemm_simt_kernel"),
    "qmatmul_gemm.simt_launches": _is("qgemm_simt_kernel"),
    "dequant_kv_cuda.launches": _is("kv_dequant_kernel"),
    "decode_attention_packed_cuda.launches": _is("kv_decode_attention_kernel"),
    "quantize_blocks_cuda.launches": _is("quantize_blocks_kernel", "quantize_blocks_vec_kernel"),
    "quantize_pack_cuda.launches": _is("quantize_pack_kernel"),
    "qmatmul_gemv_experts.launches": lambda base, name: base in _GEMV_TC and _experts(name),
    # NCCL's collective kernels (a mesh's all-gathers and all-reduces; no
    # wrapper counts them)
    "nccl": lambda base, name: base.startswith("nccl"),
}


def collective_nodes(nodes) -> dict:
    """A graph's NCCL nodes: its kernels (``KERNEL_NODES["nccl"]``) and its
    device copies of the default kind, the node NCCL records for a
    collective of one rank (PyTorch's own device copies are "DtoD")."""
    return {"kernels": route_counts(nodes)["nccl"],
            "copies": sum(n.type == "MEMCPY" and n.kind == "default" for n in nodes)}


def kernel_families(nodes) -> Counter:
    """Kernel nodes by base name (templated kernels grouped)."""
    return Counter(kernel_base_name(n.kernel or "?") for n in nodes if n.type == "KERNEL")


def route_counts(nodes) -> dict:
    """{counter name: the graph's kernel nodes of that hand-written kernel}."""
    out = dict.fromkeys(KERNEL_NODES, 0)
    for n in nodes:
        if n.type != "KERNEL" or not n.kernel:
            continue
        base = kernel_base_name(n.kernel)
        for key, pred in KERNEL_NODES.items():
            out[key] += bool(pred(base, n.kernel))
    return out


# ---------------------------------------------------------------------------
# report (the reference's)


@dataclass
class Check:
    program: str
    check: str
    ok: bool
    detail: str = ""

    def render(self) -> str:
        mark = "ok " if self.ok else "FAIL"
        return f"[{mark}] {self.program:<34s} {self.check:<22s} {self.detail}"


@dataclass
class AuditReport:
    checks: list = field(default_factory=list)
    families: dict = field(default_factory=dict)  # program -> Counter of kernel nodes
    notes: list = field(default_factory=list)

    def add(self, program: str, check: str, ok: bool, detail: str = ""):
        self.checks.append(Check(program, check, bool(ok), detail))

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def failures(self) -> list:
        return [c for c in self.checks if not c.ok]

    def render(self) -> str:
        lines = [c.render() for c in self.checks]
        for program, fam in self.families.items():
            lines.append(f"kernel nodes {program}: {sum(fam.values())} — "
                         + ", ".join(f"{k} {v}" for k, v in fam.most_common()))
        return "\n".join(lines + self.notes)


# ---------------------------------------------------------------------------
# capture instrumentation


class _capture_guard:
    """Records every .item(), .cpu(), .tolist(), .numpy(), int(), float(),
    bool() or index use of a CUDA tensor inside the bodies that the port
    captures as CUDA graphs (serving.engine.capture_graph, which the Engine
    and the Server call), while the guard is open.  Yields the list of
    calls seen."""

    NAMES = ("item", "cpu", "tolist", "numpy", "__int__", "__float__", "__bool__", "__index__")

    def __init__(self, torch):
        self.torch = torch
        self.calls = []
        self.inside = False

    def __enter__(self):
        from repro_torch.serving import engine as engine_mod
        from repro_torch.serving import server as server_mod

        Tensor = self.torch.Tensor
        self.saved = {n: getattr(Tensor, n) for n in self.NAMES}
        self.own = {n for n in self.NAMES if n in Tensor.__dict__}
        self.capture = engine_mod.capture_graph
        self.mods = (engine_mod, server_mod)
        guard = self

        def watched(name, real):
            def call(t, *a, **k):
                if guard.inside and t.is_cuda:
                    guard.calls.append(name)
                return real(t, *a, **k)
            return call

        for n, real in self.saved.items():
            setattr(Tensor, n, watched(n, real))

        def capture(body, device, generator=None, **kw):
            def guarded():
                guard.inside = True
                try:
                    body()
                finally:
                    guard.inside = False
            return guard.capture(guarded, device, generator, **kw)

        for m in self.mods:
            m.capture_graph = capture
        return self.calls

    def __exit__(self, *exc):
        for n, real in self.saved.items():
            if n in self.own:
                setattr(self.torch.Tensor, n, real)
            else:
                delattr(self.torch.Tensor, n)
        for m in self.mods:
            m.capture_graph = self.capture
        return False


class CaptureLog:
    """While open, every ``capture_graph`` call of the Engine and the Server
    captures with ``debug=True`` (so its graph can be dumped) and is kept:
    ``steps`` lists the ``CapturedStep``s in capture order."""

    def __enter__(self):
        from repro_torch.serving import engine as engine_mod
        from repro_torch.serving import server as server_mod

        self.steps = []
        self.mods = (engine_mod, server_mod)
        self.real = engine_mod.capture_graph
        log = self

        def capture(body, device, generator=None, **kw):
            step = log.real(body, device, generator, **{**kw, "debug": True})
            log.steps.append(step)
            return step

        for m in self.mods:
            m.capture_graph = capture
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.capture_graph = self.real
        return False


# ---------------------------------------------------------------------------
# buffers and memory


def _cache_leaves(prefix: str, caches) -> dict:
    return {f"{prefix}[{i}].{k}": leaf for i, group in enumerate(caches)
            for k, leaf in group.items()}


def engine_buffers(graph) -> dict:
    """{name: tensor} of an Engine ``_DecodeGraph``'s static buffers."""
    out = {k: getattr(graph, k) for k in ("tok", "pos", "temps", "done", "out", "col")}
    out.update(_cache_leaves("caches", graph.caches))
    return out


def server_buffers(srv) -> dict:
    """{name: tensor} of what the Server's captured step reads and writes."""
    out = {"_tok": srv._tok, "_temps_dev": srv._temps_dev, "_nxt": srv._nxt,
           "pool._pos_dev": srv.pool._pos_dev}
    if hasattr(srv.pool, "_page_map_dev"):
        out["pool._page_map_dev"] = srv.pool._page_map_dev
    out.update(_cache_leaves("pool.caches", srv.pool.caches))
    return out


def _pointers(buffers: dict) -> dict:
    return {k: t.data_ptr() for k, t in buffers.items()}


def _moved(before: dict, after: dict) -> list:
    return sorted(k for k in before.keys() | after.keys() if before.get(k) != after.get(k))


def slot_row_bytes(pool) -> int:
    """The bytes of one slot's rows over every cache leaf (a paged pool: a
    row's worth of pages)."""
    per = getattr(pool, "pages_per_seq", 1)
    return sum(leaf[:, 0].numel() * leaf.element_size() * per
               for group in pool.caches for leaf in group.values())


def _storages(obj, out: set) -> set:
    if isinstance(obj, torch.Tensor):
        out.add(obj.untyped_storage().data_ptr())
    elif isinstance(obj, dict):
        for v in obj.values():
            _storages(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _storages(v, out)
    return out


class _FreshBytes(TorchDispatchMode):
    """Bytes of the fresh storage that ops create on ``device`` (outputs not
    aliasing an input): on the CPU, where no allocator keeps a peak, the
    bound on what a call adds."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self.fresh = {}   # storage pointer -> bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = _storages([args, kwargs or {}], set())
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and t.device == self.device:
                ptr = t.untyped_storage().data_ptr()
                if ptr not in inputs:
                    self.fresh[ptr] = t.untyped_storage().nbytes()
        return out


class PoolWatch:
    """Wraps a pool's eager spill, restore and page wipe (kvcache.py,
    pages.py): each outermost call must keep every cache leaf's storage and
    grow peak memory by less than one slot's rows.  On CUDA the growth is
    the allocator's peak over the call; on the CPU the fresh storage the
    call creates on the pool's device and does not return."""

    OPS = ("spill_slot", "restore_slot", "_wipe_pages")

    def __init__(self, pool):
        self.pool = pool
        self.limit = slot_row_bytes(pool)
        self.calls = {op: [] for op in self.OPS}   # op -> [(kept, growth bytes)]
        self.depth = 0
        for op in self.OPS:
            if hasattr(pool, op):
                setattr(pool, op, self._wrap(op, getattr(pool, op)))

    def _wrap(self, op, real):
        watch = self

        def call(*args, **kwargs):
            if watch.depth:
                return real(*args, **kwargs)
            pool, dev = watch.pool, watch.pool.device
            before = _pointers(_cache_leaves("caches", pool.caches))
            watch.depth += 1
            try:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    out = real(*args, **kwargs)
                    torch.cuda.synchronize(dev)
                    growth = torch.cuda.max_memory_allocated(dev) - base
                else:
                    with _FreshBytes(dev) as fresh:
                        out = real(*args, **kwargs)
                    returned = _storages(out, set())
                    growth = sum(b for p, b in fresh.fresh.items() if p not in returned)
            finally:
                watch.depth -= 1
            kept = not _moved(before, _pointers(_cache_leaves("caches", pool.caches)))
            watch.calls[op].append((kept, growth))
            return out

        return call

    def report(self, report: AuditReport, program: str) -> None:
        for op, calls in self.calls.items():
            if not calls:
                continue
            kept = all(k for k, _ in calls)
            worst = max(g for _, g in calls)
            report.add(program, f"in_place[{op.strip('_')}]", kept and worst < self.limit,
                       f"{len(calls)} calls, storage {'kept' if kept else 'REBOUND'}, "
                       f"peak +{worst} B (< {self.limit} B, one slot's rows)")


def _replay_memory(step, reset=None, n: int = MEMORY_REPLAYS) -> tuple[int, int]:
    """torch.cuda.memory_allocated() before and after ``n`` replays of a
    captured step (``reset`` runs in place before every 8th, so a step that
    advances a position stays inside its buffers)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for i in range(n):
        if reset is not None and i % 8 == 0:
            reset()
        step.replay()
    torch.cuda.synchronize()
    return before, torch.cuda.memory_allocated()


# ---------------------------------------------------------------------------
# the graph checks


def audit_graph(report: AuditReport, program: str, step, dot_path: Path, *,
                expect: dict | None = None) -> list:
    """Dump one captured step's graph and run the graph checks on it:
    no_host_nodes, kernel_route (and, given ``expect`` {counter name:
    nodes}, the kernel nodes it names).  Returns the parsed nodes."""
    dot_path = Path(dot_path)
    dot_path.parent.mkdir(parents=True, exist_ok=True)
    step.dump_dot(dot_path)
    nodes = parse_dot(dot_path.read_text())
    if not nodes:
        report.add(program, "graph_dumped", False, f"no node parsed from {dot_path}")
        return nodes
    host = [n for n in nodes if n.type == "HOST"]
    copies = [n for n in nodes if n.type == "MEMCPY" and n.touches_host]
    report.add(program, "no_host_nodes", not host and not copies,
               f"{len(nodes)} nodes: {len(host)} host nodes, {len(copies)} host memcpys"
               + (f" ({sorted({n.kind_text for n in copies})})" if copies else ""))
    routes = route_counts(nodes)
    recorded = dict(zip(launches.names(), step.launched, strict=True))
    off = {k: (routes[k], recorded[k]) for k in recorded if routes[k] != recorded[k]}
    seen = ", ".join(f"{k.split('.')[0]} {v}" for k, v in routes.items() if v) or "none"
    report.add(program, "kernel_route", not off,
               f"differ (nodes, launches): {off}" if off
               else f"graph nodes = recorded launches for every counter ({seen})")
    if expect:
        got = {k: routes[k] for k in expect}
        report.add(program, "kernel_nodes", got == expect, f"{got} (want {expect})")
    report.families[program] = kernel_families(nodes)
    return nodes


def _syncs_check(report, program, syncs):
    report.add(program, "no_host_syncs", not syncs,
               f"{len(syncs)} host syncs while capturing" + (f": {syncs[:5]}" if syncs else ""))


def quantized_matrices(cfg) -> int:
    """A dense decoder's quantized matrices: 7 a layer (wq, wk, wv, wo,
    w_gate, w_up, w_down) and an untied lm_head."""
    return 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)


# ---------------------------------------------------------------------------
# workload drivers (deterministic)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int64) for n in lens]


@torch.inference_mode()
def audit_engine(report: AuditReport, params, cfg, tag: str, *, device, batches=(2, 3),
                 prompt_len: int = 8, new_tokens: int = 6, max_seq_len: int = 32,
                 expect: dict | None = None, dot_dir: Path = DOT_DIR) -> None:
    """The Engine's captured decode step for each batch size: greedy and
    sampled generates, then the checks.  On the CPU there is no graph:
    recapture counts zero captures."""
    from repro_torch.serving import Engine

    dev = torch.device(device)
    eng = Engine(params, cfg, max_seq_len=max_seq_len, device=dev)
    program = f"engine.decode_step[{tag}]"
    cuda = dev.type == "cuda"
    with CaptureLog() as log, _capture_guard(torch) as syncs:
        pointers = {}
        for B in batches:
            if cuda:   # capture now, as generate would, and note its buffers
                pointers[B] = _pointers(engine_buffers(eng._decode_graph(B)))
            prompts = torch.as_tensor(np.stack(_prompts(cfg, [prompt_len] * B, seed=B)),
                                      device=dev)
            gen = torch.Generator(dev).manual_seed(B)
            for temperature in (0.0, 0.8):
                out = eng.generate(prompts, new_tokens, temperature=temperature, generator=gen)
                if tuple(out.shape) != (B, new_tokens):
                    report.add(program, "tokens", False, f"shape {tuple(out.shape)}")
    n_cap = len(log.steps)
    want = len(batches) if cuda else 0
    report.add(program, "recapture", n_cap == want,
               f"{n_cap} captures for {len(batches)} batch sizes (want {want})")
    if not cuda:
        return
    _syncs_check(report, program, syncs)
    moved = [f"{B}:{k}" for B in batches
             for k in _moved(pointers[B], _pointers(engine_buffers(eng._graphs[B])))]
    g = eng._graphs[batches[0]]
    before, after = _replay_memory(
        g.step, reset=lambda: (g.col.fill_(1), g.pos.fill_(prompt_len)))
    report.add(program, "in_place", not moved,
               f"{sum(len(p) for p in pointers.values())} buffers kept their storage"
               if not moved else f"rebound: {moved[:6]}")
    report.add(program, "in_place[replays]", after <= before,
               f"memory_allocated {before} -> {after} B over {MEMORY_REPLAYS} replays")
    for B, step in zip(batches, log.steps):
        audit_graph(report, f"{program[:-1]},B{B}]", step, Path(dot_dir) / f"engine_{tag}_B{B}.dot",
                    expect=expect)


@torch.inference_mode()
def _audit_server(report: AuditReport, make, traffic, program: str, *, device,
                  expect: dict | None, dot_dir: Path, dot_name: str,
                  want_preempt: bool = False) -> None:
    """Build a Server (which captures its pool step), drive ``traffic`` to
    the drain and run the checks."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    with CaptureLog() as log, _capture_guard(torch) as syncs:
        srv = make()
        pointers = _pointers(server_buffers(srv))
        watch = PoolWatch(srv.pool)
        ids = [srv.submit(p, max_new=m, arrival_time=a, priority=pr)
               for p, m, a, pr in traffic]
        res = srv.run_until_drained()
    answered = all(1 <= len(res[i]) <= m for i, (_, m, _, _) in zip(ids, traffic))
    report.add(program, "drained", answered and srv.pool.n_free == srv.pool.num_slots,
               f"{len(ids)} requests answered within budget")
    n_cap, want = len(log.steps), 1 if cuda else 0
    report.add(program, "recapture", n_cap == want,
               f"{n_cap} captures across {srv.steps} steps, "
               f"{srv.scheduler.n_preemptions} preemptions (want {want})")
    if want_preempt:
        report.add(program, "preemption_forced", srv.scheduler.n_preemptions > 0,
                   f"n_preemptions={srv.scheduler.n_preemptions}")
    moved = _moved(pointers, _pointers(server_buffers(srv)))
    report.add(program, "in_place", not moved,
               f"{len(pointers)} buffers kept their storage" if not moved
               else f"rebound: {moved[:6]}")
    watch.report(report, program)
    if cuda and log.steps:
        _syncs_check(report, program, syncs)
        before, after = _replay_memory(log.steps[0])
        report.add(program, "in_place[replays]", after <= before,
                   f"memory_allocated {before} -> {after} B over {MEMORY_REPLAYS} replays")
        audit_graph(report, program, log.steps[0], Path(dot_dir) / dot_name, expect=expect)


def audit_server_slot(report: AuditReport, params, cfg, tag: str, *, device,
                      expect: dict | None = None, dot_dir: Path = DOT_DIR, server=None):
    """The slot Server with a forced preemption (the reference's traffic:
    two background requests fill the pool, an urgent one evicts one)."""
    from repro_torch.serving import Server

    cls = server or Server
    traffic = [(p, 10, float(i), prio) for i, (p, prio) in
               enumerate(zip(_prompts(cfg, [12, 12, 12], seed=2), (1, 1, 0)))]
    _audit_server(
        report, lambda: cls(params, cfg, num_slots=2, max_seq_len=32, max_preemptions=2,
                            device=device),
        traffic, f"server.decode_step[{tag}]", device=device, expect=expect, dot_dir=dot_dir,
        dot_name=f"server_{tag}.dot", want_preempt=True)


def audit_server_chunked(report: AuditReport, params, cfg, tag: str, *, device,
                         dot_dir: Path = DOT_DIR):
    """The chunked Server: two prompts longer than a chunk of
    ``attention.Q_PIECE`` (the card's chunk unit) in a bucket of 256."""
    from repro_torch.models.attention import Q_PIECE
    from repro_torch.serving import Server

    traffic = [(p, 4, float(i), 0) for i, p in enumerate(_prompts(cfg, [200, 150], seed=3))]
    _audit_server(
        report, lambda: Server(params, cfg, num_slots=2, max_seq_len=288,
                               prefill_chunk=Q_PIECE, device=device),
        traffic, f"server.chunked[{tag}]", device=device, expect=None, dot_dir=dot_dir,
        dot_name=f"server_chunked_{tag}.dot")


def audit_server_paged(report: AuditReport, params, cfg, tag: str, *, device,
                       dot_dir: Path = DOT_DIR):
    """The paged Server across a remap sweep: two buckets, slot churn and a
    forced preemption remap the page tables while one graph serves them."""
    from repro_torch.serving import Server

    traffic = [(p, 6, float(i), prio) for i, (p, prio) in enumerate(zip(
        _prompts(cfg, [12, 12, 5, 7, 12], seed=4), (1, 1, 0, 0, 1)))]
    _audit_server(
        report, lambda: Server(params, cfg, num_slots=2, max_seq_len=64, paged=True,
                               page_size=8, max_preemptions=2, device=device),
        traffic, f"server.paged[{tag}]", device=device, expect=None, dot_dir=dot_dir,
        dot_name=f"server_paged_{tag}.dot", want_preempt=True)


def _check_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the captured-graph audit needs a CUDA device: its checks read the "
                           "graphs the card captures; pass device='cpu' (--device cpu) for the "
                           "eager checks alone")
    return dev


def run_audit(arch: str = "tiny-160k", kv_bits=(16, 8, 4), fused_bits: int = 4, *,
              device=None, full: str | None = None, dot_dir: Path = DOT_DIR) -> AuditReport:
    """The grid (the reference's, ``repro/analysis/audit.py``): ``arch`` at
    each kv_bits through the Engine and the slot, chunked and paged Servers,
    and the ``fused_bits``-bit float b64 fused slot Server; with ``full``
    (an arch name, on the card) also that arch at full width and depth,
    4-bit and kv4, its Engine's batch-4 decode graph and its Server's pool
    graph.  Raises without a card unless ``device="cpu"``."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params

    dev = _check_device(device)
    report = AuditReport()
    base = get_arch(arch)
    qcfg = QuantConfig(bits=fused_bits, dtype="float", block_size=64)
    for kv in kv_bits:
        cfg = base if kv == 16 else base.with_kv_quant(kv)
        tag = f"kv{kv}"
        params = lm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        audit_engine(report, params, cfg, tag, device=dev, dot_dir=dot_dir)
        audit_server_slot(report, params, cfg, tag, device=dev, dot_dir=dot_dir)
        audit_server_chunked(report, params, cfg, tag, device=dev, dot_dir=dot_dir)
        audit_server_paged(report, params, cfg, tag, device=dev, dot_dir=dot_dir)
        # fused: the packed codes reach B1's GEMV inside the captured step,
        # one node a quantized matrix
        qparams = quantize_params(params, qcfg, cfg, device=dev)
        fcfg = cfg.with_matmul_mode("fused")
        expect = {"qmatmul_gemv.launches": quantized_matrices(cfg)} if dev.type == "cuda" \
            else None
        audit_server_slot(report, qparams, fcfg, f"{tag}+fused", device=dev, expect=expect,
                          dot_dir=dot_dir)
    if full is not None and dev.type == "cuda":
        cfg = get_arch(full).with_kv_quant(4)
        params = lm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64),
                                  cfg, device=dev)
        del params
        audit_full(report, qparams, cfg, device=dev, dot_dir=dot_dir)
    if dev.type != "cuda":
        report.notes.append("graph checks (no_host_nodes, no_host_syncs, kernel_route, "
                            "in_place over replays) not run: no graph on the CPU")
    return report


@torch.inference_mode()
def audit_generate(report: AuditReport, engine, prompts, new_tokens: int, program: str,
                   dot_path: Path, *, expect: dict | None = None) -> list:
    """One ``engine.generate`` captured and audited (on the card): one
    capture, then no_host_nodes, kernel_route (and ``expect``) and
    no_host_syncs on its step — a sharded Engine's (``sharder=``: MoE, SSM
    and hybrid decoders on a mesh, its collectives inside the graph) as
    well as an unsharded one's.  Returns the graph's nodes."""
    with CaptureLog() as log, _capture_guard(torch) as syncs:
        engine.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    report.add(program, "recapture", len(log.steps) == 1,
               f"{len(log.steps)} captures for one batch size (want 1)")
    nodes = audit_graph(report, program, log.steps[0], dot_path, expect=expect) \
        if log.steps else []
    _syncs_check(report, program, syncs)
    return nodes


def full_expect(cfg) -> dict:
    """A full-width 4-bit kv4 decode graph's hand-written kernel nodes: one
    tensor-core GEMV a quantized matrix, one fused attention a layer."""
    return {"qmatmul_gemv_tc.launches": quantized_matrices(cfg),
            "decode_attention_packed_cuda.launches": cfg.n_layers,
            "dequant_kv_cuda.launches": 0}


def audit_full(report: AuditReport, qparams, cfg, *, device, dot_dir: Path = DOT_DIR,
               batch: int = 4, prompt_len: int = 256, new_tokens: int = 8,
               num_slots: int = 8, slot_len: int = 576) -> None:
    """A full-width model's Engine decode graph (``batch`` rows) and its
    Server's pool graph (``num_slots`` slots, a forced preemption)."""
    from repro_torch.serving import Server

    tag = f"{cfg.name},kv{cfg.kv_bits}"
    expect = full_expect(cfg)
    audit_engine(report, qparams, cfg, tag, device=device, batches=(batch,),
                 prompt_len=prompt_len, new_tokens=new_tokens,
                 max_seq_len=prompt_len + new_tokens, expect=expect, dot_dir=dot_dir)
    lens = [16, 64, 128, 256] * (num_slots // 4) + [32]
    prios = [1] * (len(lens) - 1) + [0]
    traffic = [(p, 8, 0.0 if i < num_slots else 2.0, pr)
               for i, (p, pr) in enumerate(zip(_prompts(cfg, lens, seed=5), prios))]
    _audit_server(
        report, lambda: Server(qparams, cfg, num_slots=num_slots, max_seq_len=slot_len,
                               max_preemptions=1, device=device),
        traffic, f"server.decode_step[{tag}]", device=device, expect=expect,
        dot_dir=dot_dir, dot_name=f"server_{cfg.name}.dot", want_preempt=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.audit",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tiny-160k")
    ap.add_argument("--kv-bits", type=int, nargs="+", default=[16, 8, 4])
    ap.add_argument("--full", default=None,
                    help="also audit this arch at full width and depth (4-bit, kv4)")
    ap.add_argument("--device", default=None,
                    help="cpu: the eager checks alone (default: the card)")
    ap.add_argument("--dot-dir", default=str(DOT_DIR))
    args = ap.parse_args(argv)
    report = run_audit(arch=args.arch, kv_bits=tuple(args.kv_bits), device=args.device,
                       full=args.full, dot_dir=Path(args.dot_dir))
    print(report.render())
    n_fail = len(report.failures())
    print(f"audit: {'OK' if report.ok else 'FAIL'} — "
          f"{len(report.checks)} checks, {n_fail} failures")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
