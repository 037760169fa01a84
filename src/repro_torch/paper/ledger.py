"""Bench regression ledger of the port — port of ``benchmarks/ledger.py``:
normalized run records of the serving and kernel benches, kept in two files
at the repo root, ``BENCH_SERVE_TORCH.json`` and ``BENCH_KERNELS_TORCH.json``,
which ``paper/bench_diff.py`` diffs a fresh run against.  The reference's
``BENCH_SERVE.json`` and ``BENCH_KERNELS.json`` are never written here: they
are the baseline a port run is held to.

Schema (``repro-bench-ledger/v1``, the reference's): a ledger file is

    {"schema": "repro-bench-ledger/v1", "suite": "serve" | "kernels",
     "runs": [record, ...]}

and each record is

    {"meta": {git_sha, torch_version, cuda_version, platform, device_kind,
              n_devices, created_at, args[, power_limit]},  # common.run_meta
     "series": {name: {"value": float, "unit": str,
                       "clock": "virtual" | "wall",
                       "direction": "lower" | "higher",
                       "tol": float}}}          # tol = relative tolerance

``virtual`` series (engine steps, admission-wait steps, weight bytes) are
deterministic functions of the policy and the packing, the same on every
machine, so a diff gates on them within their ``tol``; ``wall`` series
(tokens/s, latencies, microseconds) are reported only.  ``direction`` says
which way is better.

One deliberate difference from the reference's ``validate_record``: where
the reference requires ``meta.jax_version``, a record here needs one
non-empty framework version, ``torch_version`` (the port's records) or
``jax_version`` (the reference's), beside ``git_sha``, ``platform``,
``device_kind`` and ``created_at``.  So the port loads the reference's
committed ledgers as they are and diffs its own runs against them.

Running the pinned workloads (on the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.paper.ledger [--device cpu]
    PYTHONPATH=src python -m repro_torch.paper.ledger --update

Without ``--update`` the records go to one-run candidate ledgers,
``artifacts/bench_torch/BENCH_{SERVE,KERNELS}.candidate.json``; with it they
are appended to ``BENCH_SERVE_TORCH.json`` and ``BENCH_KERNELS_TORCH.json``.
Also a suite: ``python -m repro_torch.paper.run --only ledger``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

LEDGER_SCHEMA = "repro-bench-ledger/v1"
ROOT = Path(__file__).resolve().parents[3]
#: the port's ledgers (``--update`` appends here)
SERVE_LEDGER = ROOT / "BENCH_SERVE_TORCH.json"
KERNEL_LEDGER = ROOT / "BENCH_KERNELS_TORCH.json"
#: the reference's committed ledgers: read-only baselines for the port
REFERENCE_SERVE_LEDGER = ROOT / "BENCH_SERVE.json"
REFERENCE_KERNEL_LEDGER = ROOT / "BENCH_KERNELS.json"
SUITES = ("serve", "kernels")
#: a record's framework version: the port's or the reference's
FRAMEWORK_KEYS = ("torch_version", "jax_version")

#: pinned serve workload for the ledger record (the reference's)
SERVE_ARGS = dict(arch="tiny-160k", num_slots=4, n_requests=12,
                  rate=4.0, kv_bits=4)

#: pinned shared-prefix workload for the paged series (the reference's)
PAGED_ARGS = dict(arch="tiny-160k", num_slots=4, n_requests=12,
                  rate=4.0, kv_bits=4, page_size=8)

_REQ_SERIES = {"value", "unit", "clock", "direction", "tol"}


def make_record(series: dict, meta: dict | None = None, device=None) -> dict:
    if meta is None:
        from repro_torch.paper import common

        meta = common.run_meta(device=device)
    rec = {"meta": meta, "series": series}
    validate_record(rec)
    return rec


def validate_record(rec: dict) -> dict:
    """Schema check for one run record; raises ValueError with the
    offending key path.  Returns the record for chaining."""

    def fail(msg):
        raise ValueError(f"ledger record: {msg}")

    if not isinstance(rec, dict):
        fail(f"expected an object, got {type(rec).__name__}")
    for key in ("meta", "series"):
        if key not in rec:
            fail(f"missing {key!r}")
    meta = rec["meta"]
    if not isinstance(meta, dict):
        fail("meta must be an object")
    for key in ("git_sha", "platform", "device_kind", "created_at"):
        if not isinstance(meta.get(key), str) or not meta.get(key):
            fail(f"meta.{key} must be a non-empty string")
    if not any(isinstance(meta.get(k), str) and meta.get(k) for k in FRAMEWORK_KEYS):
        fail(f"meta needs a non-empty framework version: one of {FRAMEWORK_KEYS}")
    if not isinstance(rec["series"], dict) or not rec["series"]:
        fail("series must be a non-empty object")
    for name, s in rec["series"].items():
        if not isinstance(s, dict):
            fail(f"series[{name!r}] must be an object")
        missing = _REQ_SERIES - set(s)
        if missing:
            fail(f"series[{name!r}] missing {sorted(missing)}")
        if not isinstance(s["value"], (int, float)) or s["value"] != s["value"]:
            fail(f"series[{name!r}].value must be a finite number")
        if s["clock"] not in ("virtual", "wall"):
            fail(f"series[{name!r}].clock must be 'virtual' or 'wall', "
                 f"got {s['clock']!r}")
        if s["direction"] not in ("lower", "higher"):
            fail(f"series[{name!r}].direction must be 'lower' or "
                 f"'higher', got {s['direction']!r}")
        if not isinstance(s["tol"], (int, float)) or s["tol"] < 0:
            fail(f"series[{name!r}].tol must be a number >= 0")
    return rec


def load(path) -> dict:
    """Load + validate a ledger file (every record)."""
    with open(path) as f:
        led = json.load(f)
    if led.get("schema") != LEDGER_SCHEMA:
        raise ValueError(
            f"{path}: schema {led.get('schema')!r} != {LEDGER_SCHEMA!r}")
    if led.get("suite") not in SUITES:
        raise ValueError(f"{path}: suite must be one of {SUITES}, "
                         f"got {led.get('suite')!r}")
    runs = led.get("runs")
    if not isinstance(runs, list) or not runs:
        raise ValueError(f"{path}: runs must be a non-empty list")
    for i, rec in enumerate(runs):
        try:
            validate_record(rec)
        except ValueError as e:
            raise ValueError(f"{path}: runs[{i}]: {e}") from e
    return led


def write(path, suite: str, runs: list) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        {"schema": LEDGER_SCHEMA, "suite": suite, "runs": runs},
        indent=1, default=float) + "\n")
    return p


def append(path, record: dict, suite: str) -> Path:
    """Append one validated record to a ledger file (created if absent)."""
    validate_record(record)
    p = Path(path)
    runs = load(p)["runs"] if p.exists() else []
    runs.append(record)
    return write(p, suite, runs)


def _s(value, unit, clock, direction, tol=0.0) -> dict:
    return {"value": float(value), "unit": unit, "clock": clock,
            "direction": direction, "tol": float(tol)}


def serve_series(stats: dict, kv_bits: int = 4) -> dict:
    """Normalize a serve_bench.run() stats dict into ledger series.
    Virtual series carry tol=0 where they are exact (step counts, byte
    ratios) and a relative tol where backend numerics enter (the logit
    gap)."""
    b = kv_bits
    return {
        f"serve.kv{b}_steps":
            _s(stats[f"kv{b}_steps"], "engine_steps", "virtual", "lower"),
        f"serve.kv{b}_mean_latency_steps":
            _s(stats[f"kv{b}_mean_latency_steps"], "engine_steps",
               "virtual", "lower"),
        f"serve.kv{b}_batch_fill":
            _s(stats[f"kv{b}_batch_fill"], "frac", "virtual", "higher",
               tol=1e-6),
        f"serve.kv{b}_bytes_ratio":
            _s(stats[f"kv{b}_ratio"], "x_vs_kv16", "virtual", "higher"),
        f"serve.kv{b}_logit_gap":
            _s(stats[f"kv{b}_logit_gap"], "abs_logit", "virtual", "lower",
               tol=0.25),
        f"serve.tok_s_kv{b}":
            _s(stats[f"tok_s_kv{b}"], "tok_per_s", "wall", "higher"),
        f"serve.kv{b}_ttft_p99_ms":
            _s(stats[f"kv{b}_ttft_p99_ms"], "ms", "wall", "lower"),
        f"serve.kv{b}_itl_p50_ms":
            _s(stats[f"kv{b}_itl_p50_ms"], "ms", "wall", "lower"),
    }


def paged_series(stats: dict) -> dict:
    """Normalize a serve_bench.run_paged() stats dict: residency and the
    byte ratio at equal memory are exact virtual series; paged tokens/s is
    wall."""
    return {
        "serve.paged_slots_resident":
            _s(stats["paged_slots_resident"], "sequences", "virtual",
               "higher"),
        "serve.paged_bytes_ratio":
            _s(stats["paged_bytes_ratio"], "frac_of_slot_bytes", "virtual",
               "lower"),
        "serve.paged_steps":
            _s(stats["paged_steps"], "engine_steps", "virtual", "lower"),
        "serve.tok_s_paged":
            _s(stats["tok_s_paged"], "tok_per_s", "wall", "higher"),
    }


def kernel_series(out: dict) -> dict:
    """Normalize a kernel_bench.run() result dict into ledger series: the
    bytes per quant tag are exact (virtual); timings and speedups are
    wall."""
    series = {}
    for tag, r in sorted(out["fused"].items()):
        series[f"kernel.{tag}_weight_bytes"] = _s(
            r["weight_bytes"], "bytes", "virtual", "lower")
        series[f"kernel.{tag}_bytes_vs_bf16"] = _s(
            r["bytes_vs_bf16"], "frac", "virtual", "lower")
        series[f"kernel.{tag}_speedup"] = _s(
            r["speedup"], "x", "wall", "higher")
        series[f"kernel.{tag}_us_fused"] = _s(
            r["us_fused"], "us", "wall", "lower")
    return series


def candidate_path(suite: str) -> Path:
    """Where ``run`` writes a suite's one-run candidate ledger."""
    from repro_torch.paper import common

    return common.ART / "bench_torch" / f"BENCH_{suite.upper()}.candidate.json"


def serve_record(log=print, *, device=None) -> dict:
    """The pinned serve and paged workloads (``SERVE_ARGS``, ``PAGED_ARGS``)
    as one serve record."""
    from repro_torch.paper import common, serve_bench

    log("  serve ledger record "
        + " ".join(f"{k}={v}" for k, v in SERVE_ARGS.items()))
    _, sstats = serve_bench.run(log, **SERVE_ARGS, device=device)
    log("  paged ledger record "
        + " ".join(f"{k}={v}" for k, v in PAGED_ARGS.items()))
    _, pstats = serve_bench.run_paged(log, **PAGED_ARGS, device=device)
    return make_record(
        {**serve_series(sstats, SERVE_ARGS["kv_bits"]), **paged_series(pstats)},
        meta=common.run_meta({**SERVE_ARGS, "paged": PAGED_ARGS["page_size"]},
                             device=device))


def run(log=print, *, update: bool = False, device=None, kernel_out=None,
        cli_args=None):
    """Suite entry (``paper/run.py --only ledger``): run the pinned serve
    and kernel workloads on ``device`` (CUDA by default), normalize them to
    ledger records and write one-run candidate ledgers under
    artifacts/bench_torch/, or append them to the port's repo-root ledgers
    with update=True.  ``kernel_out`` is a ``kernel_bench.run`` result to
    record instead of timing the kernels again.  Returns (rows, {suite:
    record})."""
    from repro_torch.device import resolve_device
    from repro_torch.paper import common, kernel_bench

    dev = resolve_device(device)
    srec = serve_record(log, device=dev)
    if kernel_out is None:
        _, kernel_out = kernel_bench.run(log, gate=False, device=dev)
    krec = make_record(kernel_series(kernel_out), meta=common.run_meta(cli_args, dev))

    rows = []
    for suite, rec, committed in (("serve", srec, SERVE_LEDGER),
                                  ("kernels", krec, KERNEL_LEDGER)):
        if update:
            p = append(committed, rec, suite)
        else:
            p = write(candidate_path(suite), suite, [rec])
        nv = sum(s["clock"] == "virtual" for s in rec["series"].values())
        log(f"  {suite}: {len(rec['series'])} series ({nv} virtual/gated) "
            f"-> {p}")
        rows.append((f"ledger/{suite}", 0.0,
                     f"series={len(rec['series'])};virtual={nv};"
                     f"out={p.name}"))
    return rows, {"serve": srec, "kernels": krec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run the pinned bench workloads and record them in "
                    "the port's regression ledger")
    ap.add_argument("--update", action="store_true",
                    help="append the fresh records to the repo-root "
                         "BENCH_SERVE_TORCH.json / BENCH_KERNELS_TORCH.json "
                         "(default: write one-run candidate ledgers to "
                         "artifacts/bench_torch/ for paper/bench_diff.py)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    run(log=lambda *a: print(*a, file=sys.stderr, flush=True),
        update=args.update, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
