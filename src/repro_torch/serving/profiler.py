"""Step profiler: roofline attribution for the serving programs — port of
``repro/serving/profiler.py``.

The serving telemetry (telemetry.py) measures *how long* each engine step
takes; this module says *how fast that is relative to the card*.  A
``StepProfiler`` attached to a recording ``Telemetry``
(``Telemetry(profiler=StepProfiler())``) makes the Server and the Engine
do three extra host-side things per program:

1. **Cost the program once.**  Before its first timed dispatch the program
   runs once more inside ``utils/cost.measure``, which counts its FLOPs
   (the dot share apart) and HBM bytes from shapes, the counterpart of the
   reference's AOT compile and HLO walk.  It runs on nothing the serving
   state shares: a program that returns new state (the Engine's prefill)
   on its real inputs, one that writes in place (a decode step, a chunk, a
   prefill into a slot or into pages) on clones of what it writes, with a
   generator of its own.  Its kernel launches are taken back from the
   counters, so they count the served work alone.  One extra run per
   program per profiled serve, never paid by an unprofiled one.
2. **Annotate the dispatch.**  Each dispatch runs inside
   ``torch.profiler.record_function("repro/<program>")``, so a trace taken
   with ``torch.profiler`` shows the engine-step structure by name.
3. **Attribute the measured time.**  The time the serving code already
   measures (host-side, behind its fences; on the card a decode step is
   one graph replay, the same graph with the profiler on or off) is divided
   into the cost: achieved FLOP/s, achieved HBM GB/s and the
   achieved-vs-roofline fraction ``max(flops/peak, bytes/bw) / measured``
   land in the ``profile_*`` gauge families, labelled per (program,
   kv_bits, matmul_mode).  Measured time is the fastest-half mean of the
   per-program ``profile_step_seconds`` histogram (noise only ever adds
   time).

On a mesh (``sharder=``) every rank costs its own slice of each program:
the FLOPs and bytes of the summary and the gauges are per rank, and each
row's ``collective_bytes`` is the rank's collective payload
(``utils/cost.py``).  The costing run issues the program's collectives, so
every rank makes it at the same point of the same serve (each rank runs
the same scheduler).

Peaks default to the H100 SXM data-sheet rates in ``device.py``
(``PEAK_FLOPS_BF16``, ``HBM_BW``); on the CPU the fraction is then "the
share of an H100's roofline", tiny but consistent: it ranks programs and
moves when a path regresses.  Pass ``peak_flops=`` / ``hbm_bw=`` for
other hardware.

Usage:

    tel = Telemetry(profiler=StepProfiler())
    srv = Server(params, cfg, ..., telemetry=tel)
    ...serve...
    print(tel.profiler.format_summary())
    # or: python -m repro_torch.launch.serve --profile --metrics-out m.prom
"""

from __future__ import annotations

import contextlib
import warnings

from repro_torch.utils.cost import ProgramCost, measure

__all__ = ["StepProfiler", "ProgramCost", "null_annotation"]

_NULL_CTX = contextlib.nullcontext()


def null_annotation(name: str):
    """The no-profiler stand-in for ``session.annotation``: a shared
    reusable null context, so dispatch sites can unconditionally write
    ``with self._annot("decode_step"):``."""
    return _NULL_CTX


class _Session:
    """One serving instance's profiler view: a private cost cache plus
    the label set (kv_bits, matmul_mode, ...) its gauges carry.  Made by
    ``StepProfiler.session``; the Server and the Engine hold one each so
    two instances sharing a profiler never mix their programs up."""

    def __init__(self, profiler: "StepProfiler", registry, labels: dict):
        self.profiler = profiler
        self.registry = registry
        self.labels = {k: str(v) for k, v in labels.items()}
        self.costs: dict[str, ProgramCost | None] = {}

    def annotation(self, name: str):
        """A ``torch.profiler`` range for one dispatch: names the program
        on any trace being captured."""
        from torch.profiler import record_function

        return record_function(f"repro/{name}")

    def ensure_costed(self, name, fn, args) -> ProgramCost | None:
        """Cost ``name`` once: run ``fn(*args)`` under ``utils/cost.measure``
        and record its FLOP/byte budget (static gauges included).
        Idempotent and failure-sticky: a program whose costing raises is
        warned about once and never retried, and serving continues
        unattributed."""
        if name in self.costs:
            return self.costs[name]
        self.costs[name] = None  # sticky: no retry loop on failure
        try:
            pc = measure(name, fn, *args)
        except Exception as e:
            warnings.warn(f"profiler could not cost {name!r}: {e}")
            return None
        self.costs[name] = pc
        lb = dict(self.labels, program=name)
        self.registry.gauge("profile_program_flops", **lb).set(pc.flops)
        self.registry.gauge("profile_program_hbm_bytes", **lb).set(pc.hbm_bytes)
        return pc

    def observe(self, name: str, dt: float) -> None:
        """Fold one measured dispatch (seconds, host fence to fence) into
        the per-program histogram and refresh the attribution gauges from
        the fastest-half mean so far."""
        lb = dict(self.labels, program=name)
        h = self.registry.histogram("profile_step_seconds", **lb)
        h.observe(dt)
        pc = self.costs.get(name)
        if pc is None:
            return
        t = h.fastest_mean(0.5)
        if not t > 0.0:
            return
        p = self.profiler
        self.registry.gauge("profile_achieved_flops_per_s", **lb).set(pc.flops / t)
        self.registry.gauge("profile_achieved_hbm_gbps", **lb).set(pc.hbm_bytes / t / 1e9)
        self.registry.gauge("profile_roofline_frac", **lb).set(
            pc.roofline_seconds(p.peak_flops, p.hbm_bw) / t)

    def summary(self) -> list[dict]:
        """One row per costed program with samples: measured fastest-half
        time and the attributed throughput/roofline numbers."""
        rows = []
        for name, pc in sorted(self.costs.items()):
            if pc is None:
                continue
            lb = dict(self.labels, program=name)
            h = self.registry.histogram("profile_step_seconds", **lb)
            if not h.count:
                continue
            t = h.fastest_mean(0.5)
            p = self.profiler
            rows.append({
                "program": name, **self.labels, "calls": h.count,
                "fastest_half_ms": t * 1e3,
                "flops": pc.flops, "dot_flops": pc.dot_flops, "hbm_bytes": pc.hbm_bytes,
                "achieved_gflops_s": pc.flops / t / 1e9,
                "achieved_hbm_gbps": pc.hbm_bytes / t / 1e9,
                "roofline_frac": pc.roofline_seconds(p.peak_flops, p.hbm_bw) / t,
                "cost_s": pc.cost_s,
            })
        return rows


class StepProfiler:
    """Roofline-attribution profiler for the serving stack.  Holds the
    peaks and the sessions; all state is host-side."""

    def __init__(self, *, peak_flops: float | None = None, hbm_bw: float | None = None):
        if peak_flops is None or hbm_bw is None:
            from repro_torch import device

            peak_flops = peak_flops or device.PEAK_FLOPS_BF16
            hbm_bw = hbm_bw or device.HBM_BW
        self.peak_flops = float(peak_flops)
        self.hbm_bw = float(hbm_bw)
        self.sessions: list[_Session] = []

    def session(self, registry, **labels) -> _Session:
        s = _Session(self, registry, labels)
        self.sessions.append(s)
        return s

    def summary(self) -> list[dict]:
        return [row for s in self.sessions for row in s.summary()]

    def format_summary(self) -> str:
        rows = self.summary()
        if not rows:
            return "profiler: no costed programs observed"
        lines = ["profiler (fastest-half means; FLOPs and bytes per rank; roofline at "
                 f"{self.peak_flops / 1e12:.0f} TFLOP/s, "
                 f"{self.hbm_bw / 1e9:.0f} GB/s):"]
        for r in rows:
            lines.append(
                f"  {r['program']:<22s} kv{r['kv_bits']:>2s}/"
                f"{r['matmul_mode']:<14s} {r['calls']:>5d} calls  "
                f"{r['fastest_half_ms']:8.3f} ms  "
                f"{r['achieved_gflops_s']:8.2f} GFLOP/s  "
                f"{r['achieved_hbm_gbps']:7.2f} GB/s  "
                f"roofline {r['roofline_frac']:.2e}"
                if "kv_bits" in r and "matmul_mode" in r else
                f"  {r['program']:<22s} {r['calls']:>5d} calls  "
                f"{r['fastest_half_ms']:8.3f} ms  "
                f"roofline {r['roofline_frac']:.2e}")
        return "\n".join(lines)
