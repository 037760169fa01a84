"""Per-request span tracing for the serving stack: JSONL event logs +
schema validation.  A copy of ``repro/serving/trace.py`` (it imports only
``json`` and ``pathlib``).

One trace event per line; the schema (version ``TRACE_VERSION``) is the
contract between the Server/Engine instrumentation, the CI smoke that
validates a live serve's trace, and any downstream consumer (the
ROADMAP's SLA scheduler reads the same lifecycle):

    {"v": 2, "kind": "span" | "event", "name": <str>,
     "request_id": <int | null>, "t0": <float>, "t1": <float | null>,
     "step": <int | null>, "attrs": {<str>: <json>}}

* ``kind: "span"`` has both ``t0`` and ``t1`` (host perf_counter
  seconds, t1 >= t0); ``kind: "event"`` has ``t0`` only (t1 null).
* ``request_id`` ties an event to one request; batched engine work
  (decode steps) carries null — its per-request effect shows up in the
  per-request token events.
* ``step`` is the server's VIRTUAL clock (engine steps), the unit
  arrival times and queue waits are expressed in; wall-clock timing
  lives in t0/t1.

Request lifecycle names (docs/observability.md#span-schema):

    submit        event — request accepted into the queue
    queue_wait    span  — submit to admission; attrs.steps = virtual wait
    prefill_chunk span  — ONE chunk of a chunked admission prefill;
                          attrs: slot, chunk (0-based index, required
                          >= 0), chunk_start, chunk_len
    prefill       span  — admission prefill dispatch to fence (chunked
                          admissions emit it at commit, after their
                          prefill_chunk spans); attrs: slot, prompt_len,
                          padded_len (the static Engine's batched
                          prefill carries a null request_id)
    token         event — one emitted token; attrs.first marks the TTFT
                          edge (only first/last tokens are traced by
                          default — the full ITL distribution lives in
                          the serve_itl_seconds histogram)
    decode_step   span  — one batched decode step; request_id null;
                          attrs: n_active, batch_fill
    preempt       event — request evicted from its slot by a
                          higher-priority admission; attrs: slot, by
                          (preemptor id), n_tokens
    spill         span  — the evicted slot's packed cache rows copied to
                          host; attrs: slot, bytes_packed, bytes_logical
    restore       span  — spilled rows written back into a re-alloc'd
                          slot at resume; attrs: slot, bytes_packed
    page_alloc    event — (--paged only) pages allocated at admission or
                          resume; attrs: slot, n_pages (fresh),
                          n_shared (COW-forked prefix pages)
    page_release  event — (--paged only) page references dropped; attrs:
                          n_pages, reason (preempt spills release the
                          private suffix; retires precede the retire
                          event so the lifecycle stays closed)
    retire        event — request finished; attrs: n_tokens, reason

``validate_events`` checks structure AND lifecycle ordering per request:
exactly one submit, retire after submit, retired requests prefilled, and
the v2 preemption counting rules — preempt only after prefill and never
nested, at most one spill per preempt, restore only after a matching
spill, no token/retire while preempted (preempts > restores).
A flight-recorder trace (``Tracer(max_events=N)``) that dropped its
oldest events exports a leading ``truncated`` event
(``attrs.dropped = N``); validation REFUSES such a trace with a clear
"truncated" diagnostic instead of a confusing lifecycle error about a
request whose submit fell off the head.

Run as a module to validate a written trace (the CI telemetry smoke);
``--stats`` adds per-family counts and a per-request duration summary,
``--chrome out.json`` converts the trace to Chrome trace-event JSON
(per-request tracks, an engine-step track, preempt->restore flow
arrows) loadable in Perfetto / chrome://tracing:

    PYTHONPATH=src python -m repro_torch.serving.trace artifacts/trace.jsonl \
        [--stats] [--chrome out.json]
"""

from __future__ import annotations

import json
from pathlib import Path

TRACE_VERSION = 2

SPAN_NAMES = {"queue_wait", "prefill", "prefill_chunk", "decode_step",
              "spill", "restore"}
#: ``page_alloc`` / ``page_release`` are emitted by --paged serving only
#: (serving/pages.py): page_alloc carries n_pages (fresh) + n_shared (COW
#: forks) per admission/resume; page_release carries n_pages + reason and
#: precedes the request's preempt/retire event.
EVENT_NAMES = {"submit", "token", "preempt", "retire", "truncated",
               "page_alloc", "page_release"}

_REQUIRED_KEYS = {"v", "kind", "name", "request_id", "t0", "t1", "step",
                  "attrs"}


class Tracer:
    """Append-only in-memory event log with JSONL export.  ``max_events``
    bounds memory on long serves by dropping the OLDEST events (the
    trace is a flight recorder; metrics aggregates never drop)."""

    def __init__(self, max_events: int | None = None):
        self.events: list[dict] = []
        self.max_events = max_events
        self.dropped = 0

    def reset(self) -> None:
        self.events.clear()
        self.dropped = 0

    def _push(self, ev: dict) -> None:
        self.events.append(ev)
        if self.max_events is not None and len(self.events) > self.max_events:
            del self.events[0]
            self.dropped += 1

    def span(self, name: str, t0: float, t1: float, *, request_id=None,
             step=None, **attrs) -> None:
        self._push({
            "v": TRACE_VERSION, "kind": "span", "name": name,
            "request_id": request_id, "t0": float(t0), "t1": float(t1),
            "step": None if step is None else int(step), "attrs": attrs,
        })

    def event(self, name: str, t: float, *, request_id=None, step=None,
              **attrs) -> None:
        self._push({
            "v": TRACE_VERSION, "kind": "event", "name": name,
            "request_id": request_id, "t0": float(t), "t1": None,
            "step": None if step is None else int(step), "attrs": attrs,
        })

    def export_events(self) -> list[dict]:
        """The events as a consumer should see them: when the flight
        recorder dropped the head, a leading ``truncated`` marker event
        (attrs.dropped) records the loss — so validation fails with a
        clear "truncated" diagnostic instead of a baffling lifecycle
        error about a request whose submit fell off the window."""
        if not self.dropped:
            return list(self.events)
        t0 = self.events[0]["t0"] if self.events else 0.0
        marker = {
            "v": TRACE_VERSION, "kind": "event", "name": "truncated",
            "request_id": None, "t0": float(t0), "t1": None, "step": None,
            "attrs": {"dropped": self.dropped,
                      "max_events": self.max_events},
        }
        return [marker] + list(self.events)

    def write_jsonl(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            for ev in self.export_events():
                f.write(json.dumps(ev) + "\n")
        return p


# ---------------------------------------------------------------------------
# validation (structure + per-request lifecycle)
# ---------------------------------------------------------------------------

def _fail(i: int, msg: str) -> None:
    raise ValueError(f"trace event {i}: {msg}")


def validate_events(events) -> dict:
    """Validate a sequence of trace-event dicts against the schema and
    the request lifecycle.  Returns summary stats ({'events', 'requests',
    'spans', 'decode_steps'}); raises ValueError with the offending event
    index on the first violation."""
    events = list(events)
    by_req: dict[int, dict] = {}
    n_spans = n_steps = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            _fail(i, f"not an object: {type(ev).__name__}")
        missing = _REQUIRED_KEYS - set(ev)
        if missing:
            _fail(i, f"missing keys {sorted(missing)}")
        if ev["v"] != TRACE_VERSION:
            _fail(i, f"schema version {ev['v']!r} (this build reads "
                     f"{TRACE_VERSION})")
        kind, name = ev["kind"], ev["name"]
        if name == "truncated":
            n = ev.get("attrs", {}).get("dropped", "?")
            _fail(i, f"trace is truncated: the flight recorder dropped "
                     f"its {n} oldest events (Tracer max_events="
                     f"{ev.get('attrs', {}).get('max_events', '?')}); "
                     f"lifecycle validation needs the complete trace — "
                     f"raise max_events or trace a shorter serve")
        if kind == "span":
            if name not in SPAN_NAMES:
                _fail(i, f"unknown span name {name!r}")
            if not isinstance(ev["t1"], (int, float)):
                _fail(i, f"span {name!r} needs numeric t1")
            if ev["t1"] < ev["t0"]:
                _fail(i, f"span {name!r} ends before it starts "
                         f"({ev['t1']} < {ev['t0']})")
            n_spans += 1
        elif kind == "event":
            if name not in EVENT_NAMES:
                _fail(i, f"unknown event name {name!r}")
            if ev["t1"] is not None:
                _fail(i, f"event {name!r} must have t1 null")
        else:
            _fail(i, f"unknown kind {kind!r}")
        if not isinstance(ev["t0"], (int, float)):
            _fail(i, f"{name!r} needs numeric t0")
        if not isinstance(ev["attrs"], dict):
            _fail(i, f"{name!r} attrs must be an object")
        rid = ev["request_id"]
        if name == "decode_step":
            if rid is not None:
                _fail(i, "decode_step is batched; request_id must be null")
            if not (0 <= ev["attrs"].get("n_active", -1)):
                _fail(i, "decode_step needs attrs.n_active >= 0")
            n_steps += 1
            continue
        if name == "prefill" and rid is None:
            continue  # static Engine: one batched prefill, no request
        if rid is None:
            _fail(i, f"{name!r} needs a request_id")
        r = by_req.setdefault(rid, {"submit": None, "retire": None,
                                    "prefill": None, "tokens": 0,
                                    "preempts": 0, "spills": 0,
                                    "restores": 0})
        if name == "submit":
            if r["submit"] is not None:
                _fail(i, f"request {rid}: duplicate submit")
            r["submit"] = ev["t0"]
        elif name == "retire":
            if r["retire"] is not None:
                _fail(i, f"request {rid}: duplicate retire")
            if r["submit"] is None:
                _fail(i, f"request {rid}: retire before submit")
            if ev["t0"] < r["submit"]:
                _fail(i, f"request {rid}: retire at {ev['t0']} precedes "
                         f"submit at {r['submit']}")
            if r["preempts"] > r["restores"]:
                _fail(i, f"request {rid}: retire while preempted "
                         f"(no restore after spill)")
            r["retire"] = ev["t0"]
        else:
            if r["submit"] is None:
                _fail(i, f"request {rid}: {name!r} before submit")
            if r["retire"] is not None:
                _fail(i, f"request {rid}: {name!r} after retire")
            if name == "prefill":
                r["prefill"] = ev["t0"]
            elif name == "prefill_chunk":
                if not (0 <= ev["attrs"].get("chunk", -1)):
                    _fail(i, f"request {rid}: prefill_chunk needs "
                             f"attrs.chunk >= 0")
            elif name == "token":
                if r["preempts"] > r["restores"]:
                    _fail(i, f"request {rid}: token while preempted")
                r["tokens"] += 1
            elif name == "preempt":
                if r["prefill"] is None:
                    _fail(i, f"request {rid}: preempt before prefill")
                if r["preempts"] > r["restores"]:
                    _fail(i, f"request {rid}: nested preempt "
                             f"(already preempted)")
                r["preempts"] += 1
            elif name == "spill":
                if r["spills"] >= r["preempts"]:
                    _fail(i, f"request {rid}: spill without a preempt")
                r["spills"] += 1
            elif name == "restore":
                if r["restores"] >= r["spills"]:
                    _fail(i, f"request {rid}: restore before spill")
                r["restores"] += 1
    for rid, r in by_req.items():
        if r["retire"] is not None and r["prefill"] is None:
            raise ValueError(f"request {rid}: retired without a prefill span")
    return {"events": len(events), "requests": len(by_req),
            "spans": n_spans, "decode_steps": n_steps}


def load_jsonl(path) -> list[dict]:
    """Parse a JSONL trace file into event dicts (no validation)."""
    events = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not valid JSON: {e}") from e
    return events


def validate_jsonl(path) -> dict:
    """Parse + validate a JSONL trace file; returns validate_events'
    summary plus the path."""
    stats = validate_events(load_jsonl(path))
    stats["path"] = str(path)
    return stats


# ---------------------------------------------------------------------------
# stats + Chrome trace-event export
# ---------------------------------------------------------------------------

def trace_stats(events) -> dict:
    """Descriptive statistics of a (validated) trace: per-family
    span/event counts and a per-request duration summary (submit to
    retire, wall seconds) — what ``--stats`` prints."""
    events = list(events)
    names: dict[str, int] = {}
    req: dict = {}
    for ev in events:
        key = f"{ev['kind']}:{ev['name']}"
        names[key] = names.get(key, 0) + 1
        rid = ev["request_id"]
        if rid is None:
            continue
        r = req.setdefault(rid, {"submit": None, "retire": None,
                                 "tokens": 0})
        if ev["name"] == "submit":
            r["submit"] = ev["t0"]
        elif ev["name"] == "retire":
            r["retire"] = ev["t0"]
            r["n_tokens"] = ev["attrs"].get("n_tokens")
        elif ev["name"] == "token":
            r["tokens"] += 1
    durs = sorted(r["retire"] - r["submit"] for r in req.values()
                  if r["submit"] is not None and r["retire"] is not None)

    def _pct(p):
        if not durs:
            return float("nan")
        idx = min(len(durs) - 1, int(round((len(durs) - 1) * p / 100.0)))
        return durs[idx]

    return {
        "names": dict(sorted(names.items())),
        "requests": {
            "count": len(req),
            "completed": len(durs),
            "duration_mean_s": sum(durs) / len(durs) if durs
            else float("nan"),
            "duration_p50_s": _pct(50),
            "duration_p99_s": _pct(99),
            "duration_max_s": durs[-1] if durs else float("nan"),
        },
    }


#: Chrome trace-event pid of the engine track / the per-request tracks
_ENGINE_PID, _REQUEST_PID = 1, 2


def to_chrome_trace(events) -> dict:
    """Convert schema-v2 trace events to Chrome trace-event JSON
    (the Perfetto / chrome://tracing format).

    Layout: one "engine" process holding the batched engine-step track
    (decode_step spans and any request-less work), one "requests"
    process with one thread per request id (its queue_wait / prefill /
    spill / restore spans and submit / token / preempt / retire instant
    events).  Each preemption draws a flow arrow from the victim's
    preempt instant to the start of its restore span, so the eviction
    round-trip PR 7 built is one visible arc.  Timestamps are
    microseconds rebased to the earliest event."""
    events = list(events)
    t_origin = min((ev["t0"] for ev in events
                    if isinstance(ev.get("t0"), (int, float))), default=0.0)

    def us(t):
        return (t - t_origin) * 1e6

    out = [
        {"ph": "M", "pid": _ENGINE_PID, "tid": 0, "ts": 0,
         "name": "process_name", "args": {"name": "engine"}},
        {"ph": "M", "pid": _ENGINE_PID, "tid": 0, "ts": 0,
         "name": "thread_name", "args": {"name": "engine steps"}},
        {"ph": "M", "pid": _REQUEST_PID, "tid": 0, "ts": 0,
         "name": "process_name", "args": {"name": "requests"}},
    ]
    seen_rids: set = set()
    n_preempts: dict = {}
    n_restores: dict = {}
    for ev in events:
        rid = ev["request_id"]
        if rid is None:
            pid, tid = _ENGINE_PID, 0
        else:
            pid, tid = _REQUEST_PID, int(rid)
            if rid not in seen_rids:
                seen_rids.add(rid)
                out.append({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                            "name": "thread_name",
                            "args": {"name": f"req {rid}"}})
        args = dict(ev["attrs"], step=ev["step"])
        base = {"name": ev["name"], "cat": "serve", "pid": pid, "tid": tid,
                "args": args}
        if ev["kind"] == "span":
            out.append(dict(base, ph="X", ts=us(ev["t0"]),
                            dur=max(0.0, (ev["t1"] - ev["t0"]) * 1e6)))
            if ev["name"] == "restore":
                n = n_restores[rid] = n_restores.get(rid, 0) + 1
                out.append({"ph": "f", "bp": "e", "cat": "preempt",
                            "name": "preemption",
                            "id": f"preempt-{rid}-{n}", "pid": pid,
                            "tid": tid, "ts": us(ev["t0"])})
        else:
            out.append(dict(base, ph="i", s="t", ts=us(ev["t0"])))
            if ev["name"] == "preempt":
                n = n_preempts[rid] = n_preempts.get(rid, 0) + 1
                out.append({"ph": "s", "cat": "preempt",
                            "name": "preemption",
                            "id": f"preempt-{rid}-{n}", "pid": pid,
                            "tid": tid, "ts": us(ev["t0"])})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.serving.trace",
                          "trace_version": TRACE_VERSION}}


def write_chrome_trace(events, path) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(to_chrome_trace(events)))
    return p


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="validate a serving trace JSONL against the span "
                    "schema; optionally print stats or export a Chrome "
                    "trace (Perfetto / chrome://tracing)"
    )
    ap.add_argument("trace", help="path to a --trace-out JSONL file")
    ap.add_argument("--stats", action="store_true",
                    help="also print per-family span/event counts and a "
                         "per-request duration summary")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="also export the trace as Chrome trace-event "
                         "JSON (per-request tracks, engine-step track, "
                         "preempt->restore flow arrows)")
    args = ap.parse_args(argv)
    try:
        events = load_jsonl(args.trace)
        stats = validate_events(events)
    except (OSError, ValueError) as e:
        print(f"invalid trace: {e}", file=sys.stderr)
        return 1
    print(f"ok: {stats['events']} events, {stats['requests']} requests, "
          f"{stats['spans']} spans ({stats['decode_steps']} decode steps) "
          f"in {args.trace}")
    if args.stats:
        ts = trace_stats(events)
        for key, n in ts["names"].items():
            print(f"  {key:<24s} {n:>7d}")
        r = ts["requests"]
        print(f"  requests: {r['count']} ({r['completed']} completed), "
              f"duration mean {r['duration_mean_s'] * 1e3:.1f}ms "
              f"p50 {r['duration_p50_s'] * 1e3:.1f}ms "
              f"p99 {r['duration_p99_s'] * 1e3:.1f}ms "
              f"max {r['duration_max_s'] * 1e3:.1f}ms")
    if args.chrome:
        p = write_chrome_trace(events, args.chrome)
        n = len(to_chrome_trace(events)["traceEvents"])
        print(f"chrome trace -> {p} ({n} trace events; open in Perfetto "
              f"or chrome://tracing)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
