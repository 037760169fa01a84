"""Serving telemetry: a dependency-free metrics registry + recorder — a
copy of ``repro/serving/telemetry.py`` (its registry and recorders; the
module is pure Python, so only the imports are repointed).

The paper's argument is a trade-off curve — bits vs. accuracy vs.
footprint — and every ROADMAP serving gate (SLA scheduler p50/p99 TTFT,
paged-KV pool occupancy, speculative acceptance rates) needs an
in-flight instrument, not an end-of-run aggregate.  This module is that
instrument: counters, gauges, and fixed-bucket histograms (with EXACT
percentile extraction — samples are retained, buckets exist for the
Prometheus-style exposition) behind a ``Telemetry`` recorder that the
serving stack threads through ``Server``/``Engine``/``Scheduler``/
``SlotKVCache`` via a ``telemetry=`` kwarg.

Two recorders, one contract:

* ``Telemetry()``  — records.  All instrumentation is HOST-SIDE ONLY:
  nothing here is ever traced into a jitted body; the serving code times
  steps at the dispatch boundary with an explicit ``block_until_ready``
  fence, so compiled programs are byte-identical with telemetry on or
  off and greedy outputs stay token-identical (tests/test_telemetry.py
  pins both).
* ``NOOP`` (the default) — a shared ``NoopTelemetry`` whose every method
  is ``pass`` and whose ``enabled`` flag is False.  Hot paths guard the
  timing work behind ``if telemetry.enabled`` so the no-op recorder
  costs one attribute check per step and zero fences.

Metric families are declared once in ``METRIC_FAMILIES`` (the single
source of truth mirrored by docs/observability.md); first use
auto-registers the metric with its documented type/buckets.  Exposition:
``registry.prometheus_text()`` (``--metrics-out`` on launch/serve.py)
and ``registry.as_dict()`` (consumed by benchmarks/serve_bench.py for
its p50/p99 TTFT and inter-token-latency columns).

Quantization health lives here too: ``record_quant_health`` snapshots
per-matrix plan bits and blockwise quantization error at load, and
``kv_roundtrip_error`` measures the append-quantize roundtrip error of
actual K/V rows (the Server's ``kv_probe_every`` hook).  Both run on the
device the tensors are on, outside any captured step.
"""

from __future__ import annotations

import math
import time
from bisect import bisect_left, insort

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Telemetry", "NoopTelemetry", "NOOP", "METRIC_FAMILIES",
    "record_quant_health", "record_tree_bits", "kv_roundtrip_error",
]


# ---------------------------------------------------------------------------
# bucket ladders (upper bounds; +Inf is implicit)
# ---------------------------------------------------------------------------

#: wall-clock latencies from 100us to 30s — covers a CPU-container tiny
#: model and a real accelerator without re-tuning
LATENCY_BUCKETS = tuple(
    round(b * m, 6) for m in (1e-4, 1e-3, 1e-2, 1e-1, 1.0)
    for b in (1.0, 2.5, 5.0)
) + (30.0,)

#: ratios in [0, 1] (batch fill, padding waste)
RATIO_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))

#: virtual-clock queue waits (engine steps)
STEP_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

#: metric family -> (type, help, histogram buckets or None).  One table,
#: mirrored in docs/observability.md#metric-families.
METRIC_FAMILIES = {
    # request lifecycle
    "serve_requests_submitted_total":
        ("counter", "requests accepted by submit()", None),
    "serve_requests_retired_total":
        ("counter", "requests finished (EOS, budget, or cache-full)", None),
    "serve_tokens_total":
        ("counter", "generated tokens emitted to callbacks", None),
    "serve_prefills_total":
        ("counter", "admission prefills dispatched", None),
    "serve_decode_steps_total":
        ("counter", "batched decode steps dispatched", None),
    # latency histograms (wall-clock seconds, host-side fences)
    "serve_ttft_seconds":
        ("histogram", "submit() to first emitted token, per request",
         LATENCY_BUCKETS),
    "serve_itl_seconds":
        ("histogram", "gap between consecutive tokens of one request",
         LATENCY_BUCKETS),
    "serve_prefill_seconds":
        ("histogram", "one admission prefill (dispatch to fence)",
         LATENCY_BUCKETS),
    "serve_decode_step_seconds":
        ("histogram", "one batched decode step (dispatch to fence)",
         LATENCY_BUCKETS),
    # scheduler / pool occupancy
    "serve_queue_depth":
        ("gauge", "requests queued, not yet admitted", None),
    "serve_requests_running":
        ("gauge", "requests currently bound to slots", None),
    "serve_queue_wait_steps":
        ("histogram", "virtual engine steps between arrival and admission",
         STEP_BUCKETS),
    "serve_slots_total": ("gauge", "slot-pool capacity", None),
    "serve_slots_active": ("gauge", "slots holding a live request", None),
    "serve_batch_fill":
        ("histogram", "active slots / pool size, per decode step",
         RATIO_BUCKETS),
    "serve_prefill_pad_frac":
        ("histogram", "padded tail / bucket length, per admission "
         "(compile-bucket waste)", RATIO_BUCKETS),
    # SLA scheduler: chunked prefill + preemption
    "serve_prefill_chunks_total":
        ("counter", "prefill chunks dispatched by chunked admissions", None),
    "serve_prefill_chunk_seconds":
        ("histogram", "one prefill chunk (dispatch to fence)",
         LATENCY_BUCKETS),
    "serve_preemptions_total":
        ("counter", "running requests evicted for a higher-priority "
         "admission", None),
    "serve_resumes_total":
        ("counter", "preempted requests restored into a slot", None),
    "serve_requests_preempted":
        ("gauge", "requests currently preempted (packed KV spilled to "
         "host, awaiting resume)", None),
    "kv_spill_bytes_total":
        ("counter", "KV bytes copied to host by preemption spills; "
         "kind=packed (as stored) | logical (bf16-equivalent)", None),
    # KV pool footprint (kvcache.kv_bytes(), one source of truth)
    "kv_pool_bytes":
        ("gauge", "resident KV bytes; kind=packed|logical|per_device", None),
    "kv_pool_compression_x":
        ("gauge", "logical (bf16-equivalent) / packed resident bytes", None),
    # paged KV pool (serving/pages.py; --paged serving only)
    "kv_pages_total":
        ("gauge", "allocatable pages in the paged pool (trash page "
         "excluded)", None),
    "kv_pages_free":
        ("gauge", "pages on the free list", None),
    "kv_pages_shared":
        ("gauge", "pages referenced by more than one sequence (COW)", None),
    "kv_pages_seqs_resident":
        ("gauge", "sequences holding pages (running + preempted "
         "prefix-retainers)", None),
    "kv_pages_alloc_total":
        ("counter", "fresh pages popped from the free list", None),
    "kv_pages_freed_total":
        ("counter", "pages returned to the free list (last reference "
         "dropped)", None),
    "kv_pages_cow_hits_total":
        ("counter", "pages forked by refcount instead of recomputed "
         "(prefix sharing)", None),
    # quantization health
    "kv_append_qerr_rms":
        ("gauge", "running mean RMS relative error of probed "
         "append-quantized K/V rows", None),
    "kv_append_qerr_max":
        ("gauge", "worst probed append-quantize RMS relative error", None),
    "kv_probe_rows_total":
        ("counter", "K/V token rows measured by the append-quantize probe",
         None),
    "quant_unit_bits":
        ("gauge", "stored bits/param of one weight matrix; unit=<tree path>",
         None),
    "quant_unit_qerr_rms":
        ("gauge", "blockwise RMS relative quantization error of one matrix "
         "at load; unit=<tree path>", None),
    # step profiler: roofline attribution per jitted program
    # (serving/profiler.py; labels program=<name>, kv_bits, matmul_mode)
    "profile_step_seconds":
        ("histogram", "one profiled program dispatch (host fence to "
         "fence); program=<jitted program>", LATENCY_BUCKETS),
    "profile_program_flops":
        ("gauge", "analytic FLOPs per call of one jitted program "
         "(trip-count-corrected HLO walk, utils/hlo.py)", None),
    "profile_program_hbm_bytes":
        ("gauge", "analytic HBM bytes per call of one jitted program "
         "(fusion-boundary traffic)", None),
    "profile_achieved_flops_per_s":
        ("gauge", "program FLOPs / fastest-half mean measured step time",
         None),
    "profile_achieved_hbm_gbps":
        ("gauge", "program HBM GB / fastest-half mean measured step time",
         None),
    "profile_roofline_frac":
        ("gauge", "roofline-predicted step time (binding compute/memory "
         "term at the configured peaks) / measured fastest-half time; "
         "1.0 = hardware limit", None),
}


# ---------------------------------------------------------------------------
# metric types
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic float counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        self.value += n


class Gauge:
    """Last-write-wins value; tracks its own high-water mark (`max`)."""

    __slots__ = ("value", "max")

    def __init__(self):
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.max:
            self.max = self.value

    def inc(self, n: float = 1.0) -> None:
        self.set(self.value + n)

    def dec(self, n: float = 1.0) -> None:
        self.set(self.value - n)


class Histogram:
    """Fixed-bucket histogram that ALSO retains every sample (sorted),
    so `percentile()` is exact rather than bucket-interpolated.

    The buckets exist for the Prometheus exposition (cumulative `le`
    counts); the sorted sample list is what serve_bench's p50/p99
    columns and the gated ROADMAP SLAs read.  Serving-scale here is
    thousands of observations per run, so exact retention is cheap; a
    production exporter would cap or decimate — `max_samples` keeps the
    newest N when set."""

    __slots__ = ("buckets", "bucket_counts", "count", "total",
                 "_samples", "max_samples")

    def __init__(self, buckets=LATENCY_BUCKETS, max_samples: int | None = None):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b
        self.bucket_counts = [0] * (len(b) + 1)  # [-1] is the +Inf bucket
        self.count = 0
        self.total = 0.0
        self._samples: list[float] = []
        self.max_samples = max_samples

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.bucket_counts[bisect_left(self.buckets, v)] += 1
        insort(self._samples, v)
        if self.max_samples is not None and len(self._samples) > self.max_samples:
            self._samples.pop(0)  # drop the smallest; tails are the signal

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, p: float) -> float:
        """Exact p-th percentile (0..100) by linear interpolation over
        the retained samples — identical to numpy.percentile(...,
        method='linear'), without importing numpy."""
        if not self._samples:
            return math.nan
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile wants 0..100, got {p}")
        s = self._samples
        idx = (len(s) - 1) * p / 100.0
        lo = math.floor(idx)
        hi = math.ceil(idx)
        if lo == hi:
            return s[int(idx)]
        return s[lo] + (s[hi] - s[lo]) * (idx - lo)

    def fastest_mean(self, frac: float = 0.5) -> float:
        """Mean of the fastest `frac` of samples — the robust estimator
        benchmarks/common.timed_robust uses on noisy shared-CPU runners
        (preemption only ever ADDS time, so the fast tail is the honest
        hardware number)."""
        if not self._samples:
            return math.nan
        keep = max(1, int(len(self._samples) * frac))
        return sum(self._samples[:keep]) / keep

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "max": self._samples[-1] if self._samples else math.nan,
        }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Named metrics with optional labels.  Families declared in
    METRIC_FAMILIES auto-register with their documented type/buckets;
    undeclared names may be created explicitly via counter()/gauge()/
    histogram() (they export with an empty help string)."""

    def __init__(self):
        # name -> (type, help, {label_key: metric})
        self._metrics: dict[str, tuple[str, str, dict]] = {}

    def _get(self, name: str, typ: str, make, labels: dict):
        fam = self._metrics.get(name)
        if fam is None:
            decl = METRIC_FAMILIES.get(name)
            help_ = decl[1] if decl else ""
            if decl and decl[0] != typ:
                raise TypeError(
                    f"metric {name!r} is declared as a {decl[0]}, not a {typ}"
                )
            fam = (typ, help_, {})
            self._metrics[name] = fam
        elif fam[0] != typ:
            raise TypeError(f"metric {name!r} already registered as {fam[0]}")
        series = fam[2]
        key = _label_key(labels)
        if key not in series:
            series[key] = make()
        return series[key]

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, "counter", Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, "gauge", Gauge, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        decl = METRIC_FAMILIES.get(name)
        if buckets is None:
            buckets = decl[2] if decl and decl[2] else LATENCY_BUCKETS
        return self._get(name, "histogram",
                         lambda: Histogram(buckets), labels)

    def reset(self) -> None:
        self._metrics.clear()

    # -- exposition --------------------------------------------------------
    def as_dict(self) -> dict:
        """{name: {label_str: value-or-summary}} — the structured view
        serve_bench and tests consume."""
        out: dict = {}
        for name, (typ, _h, series) in sorted(self._metrics.items()):
            fam: dict = {}
            for key, m in series.items():
                lbl = ",".join(f"{k}={v}" for k, v in key)
                if typ == "counter":
                    fam[lbl] = m.value
                elif typ == "gauge":
                    fam[lbl] = {"value": m.value, "max": m.max}
                else:
                    fam[lbl] = m.summary()
            out[name] = fam
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (type + help comments,
        cumulative `le` buckets, _sum/_count).  HELP text comes from the
        METRIC_FAMILIES declaration (the single source of truth) and
        label values are escaped per the exposition-format spec
        (backslash, double quote, newline)."""
        lines: list[str] = []
        for name, (typ, help_, series) in sorted(self._metrics.items()):
            decl = METRIC_FAMILIES.get(name)
            help_ = decl[1] if decl else help_
            if help_:
                lines.append(f"# HELP {name} " + _escape_help(help_))
            lines.append(f"# TYPE {name} {typ}")
            for key, m in sorted(series.items()):
                lbl = _render_labels(key)
                if typ in ("counter", "gauge"):
                    lines.append(f"{name}{lbl} {m.value:.9g}")
                else:
                    cum = 0
                    for bound, c in zip(m.buckets, m.bucket_counts):
                        cum += c
                        ble = _merge_label(key, "le", f"{bound:.9g}")
                        lines.append(f"{name}_bucket{ble} {cum}")
                    ble = _merge_label(key, "le", "+Inf")
                    lines.append(f"{name}_bucket{ble} {m.count}")
                    lines.append(f"{name}_sum{lbl} {m.total:.9g}")
                    lines.append(f"{name}_count{lbl} {m.count}")
        return "\n".join(lines) + "\n"


def _escape_label_value(v: str) -> str:
    """Exposition-format label-value escaping: backslash first, then
    double quote and newline (the three characters the spec names)."""
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(h: str) -> str:
    """HELP lines escape backslash and newline (quotes are legal)."""
    return h.replace("\\", r"\\").replace("\n", r"\n")


def _render_labels(pairs) -> str:
    if not pairs:
        return ""
    return ("{"
            + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
            + "}")


def _merge_label(key: tuple, k: str, v: str) -> str:
    return _render_labels(list(key) + [(k, v)])


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------

class Telemetry:
    """The recording backend the serving stack threads through.

    Serving code calls the thin conveniences (inc/set_gauge/observe) or
    reaches into ``registry``/``tracer`` directly; everything is plain
    host-side Python.  ``kv_probe_every=N`` asks the Server to measure
    the append-quantize roundtrip error of every Nth admission's K/V
    rows (0 = off; the probe costs one extra bf16 prefill per probed
    admission, so benches keep it off while timing)."""

    enabled = True

    def __init__(self, *, kv_probe_every: int = 0,
                 max_trace_events: int | None = None, profiler=None):
        from repro_torch.serving.trace import Tracer  # sibling, no cycle at import

        self.registry = MetricsRegistry()
        self.tracer = Tracer(max_events=max_trace_events)
        self.kv_probe_every = int(kv_probe_every)
        #: optional serving/profiler.StepProfiler: the Server/Engine open
        #: a session on it and attribute their measured step times into
        #: the profile_* gauge families (host-side only, like the rest)
        self.profiler = profiler

    # host wall clock — one place, mockable in tests
    now = staticmethod(time.perf_counter)

    def reset(self) -> None:
        """Drop all recorded state (serve_bench calls this between its
        compile pass and its timed pass; the bound Server keeps writing
        into the same object)."""
        self.registry.reset()
        self.tracer.reset()

    # -- conveniences ------------------------------------------------------
    def inc(self, name: str, n: float = 1.0, **labels) -> None:
        self.registry.counter(name, **labels).inc(n)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self.registry.gauge(name, **labels).set(value)

    def observe(self, name: str, value: float, **labels) -> None:
        self.registry.histogram(name, **labels).observe(value)

    def span(self, name, t0, t1, *, request_id=None, step=None, **attrs):
        self.tracer.span(name, t0, t1, request_id=request_id, step=step,
                         **attrs)

    def event(self, name, t, *, request_id=None, step=None, **attrs):
        self.tracer.event(name, t, request_id=request_id, step=step, **attrs)

    def write(self, metrics_out=None, trace_out=None) -> None:
        """Dump the Prometheus text exposition and/or the JSONL trace."""
        from pathlib import Path

        if metrics_out is not None:
            p = Path(metrics_out)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(self.registry.prometheus_text())
        if trace_out is not None:
            self.tracer.write_jsonl(trace_out)


def _noop(*_a, **_k) -> None:
    return None


class NoopTelemetry:
    """Absorbs the full Telemetry surface at zero cost.  ``enabled`` is
    False so hot paths skip their timing work (and their
    block_until_ready fences) entirely; an unguarded call is still safe
    — every method is a no-op."""

    enabled = False
    kv_probe_every = 0
    registry = None
    tracer = None
    profiler = None
    now = staticmethod(time.perf_counter)

    inc = set_gauge = observe = span = event = staticmethod(_noop)
    reset = write = staticmethod(_noop)


#: the shared default recorder — ``telemetry=`` kwargs point here
NOOP = NoopTelemetry()


# ---------------------------------------------------------------------------
# quantization health (torch imported lazily: the registry itself must stay
# importable in dependency-free contexts, e.g. a log post-processor)
# ---------------------------------------------------------------------------

def record_quant_health(telemetry, params, cfg, *, plan=None, qcfg=None,
                        max_units: int | None = None) -> dict:
    """Snapshot per-matrix plan bits and blockwise quantization error of
    a RAW param tree at load time (before quantize_tree consumes it).

    Records two labelled gauge families — ``quant_unit_bits{unit=...}``
    and ``quant_unit_qerr_rms{unit=...}`` — one series per quantizable
    unit, measured on exactly the storage layout that serves
    (models/quantize.quantize_unit), on the device the weights are on.
    Returns {unit: (bits, qerr)} so callers can log it.  No-op (empty
    dict) on the NOOP recorder."""
    if not telemetry.enabled:
        return {}
    import torch

    from repro_torch.core.qtensor import quantization_error
    from repro_torch.models.quantize import quantizable_units, quantize_unit

    if plan is not None:
        base = plan.default_config()
    elif qcfg is not None:
        base = qcfg
    else:
        raise ValueError("record_quant_health needs plan= or qcfg=")

    out = {}
    units = quantizable_units(params, cfg, qcfg=base)
    with torch.inference_mode():
        for i, (name, info) in enumerate(sorted(units.items())):
            if max_units is not None and i >= max_units:
                break
            ucfg = plan.config_for(name, base) if plan is not None else base
            if ucfg.bits >= 16:
                bits, qerr = 16.0, 0.0
            else:
                qt = quantize_unit(info["kind"], info["w"], ucfg,
                                   outlier_idx=info["outlier_idx"])
                x = info["w"]
                if info["kind"] in ("matrix", "moe"):
                    x = torch.swapaxes(x, -1, -2)
                bits = float(qt.bits_breakdown().ideal_bits_per_param)
                qerr = float(quantization_error(x, qt))
                del qt
            telemetry.set_gauge("quant_unit_bits", bits, unit=name)
            telemetry.set_gauge("quant_unit_qerr_rms", qerr, unit=name)
            out[name] = (bits, qerr)
    return out


def record_tree_bits(telemetry, params) -> dict:
    """Snapshot per-matrix stored bits of an ALREADY-quantized tree
    (QuantizedTensor leaves) into ``quant_unit_bits{unit=...}`` gauges.

    The load-time qerr snapshot (record_quant_health) needs the raw
    weights and so only runs when the Engine/Server does the quantizing
    (``plan=``); a pre-quantized tree still exposes its bit allocation.
    Unit names match models/quantize.py tree paths (trailing '/w'
    stripped).  Returns {unit: bits}; empty on the NOOP recorder."""
    if not telemetry.enabled:
        return {}
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.models.quantize import _paths

    out = {}
    for keys, leaf in _paths(params):
        if not isinstance(leaf, QuantizedTensor):
            continue
        keys = [str(k) for k in keys]
        if keys and keys[-1] == "w":
            keys = keys[:-1]
        name = "/".join(keys)
        bits = float(leaf.bits_breakdown().ideal_bits_per_param)
        telemetry.set_gauge("quant_unit_bits", bits, unit=name)
        out[name] = bits
    return out


def kv_roundtrip_error(rows, spec) -> float:
    """RMS relative error of encode->dequant over K/V token rows
    [..., feat] under a KVQuantSpec — the append-quantize math of the
    decode and prefill steps (kernels/kv_dequant.encode_rows) and the
    plain dequant, run eagerly on probe rows the Server harvests, outside
    any captured step."""
    import torch

    from repro_torch.kernels import kv_dequant

    x = rows.to(torch.float32)
    packed, scales = kv_dequant.encode_rows(x, spec)
    xhat = kv_dequant.dequant_rows_ref(packed, scales, spec, x.shape[-1],
                                       out_dtype=torch.float32)
    num = torch.sqrt(torch.mean((xhat - x) ** 2))
    den = torch.sqrt(torch.mean(x ** 2)) + 1e-12
    return float(num / den)
