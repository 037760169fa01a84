"""Continuous vs static batching under bursty traffic, across KV-cache
precisions — port of ``benchmarks/serve_bench.py``.

Workload: a Poisson-arrival mixed-length request stream
(``data/synthetic.serving_workload``) served by the paper's recommended
deployment config (4-bit float weights, block 64).

* static: the ``Engine``, requests grouped by prompt length (its only legal
  batching), each batch decoded to its LONGEST member's budget.  The
  grouping ignores arrival times, so the static baseline is an offline
  oracle and the measured speedup a lower bound on the online gap.
* continuous: the ``Server``'s slot pool, free slots re-prefilled
  mid-flight.

Both paths run the same decode math over the same tree, so tokens/s
differences are scheduling; greedy outputs are checked token-identical per
request before any number is reported.  Each path serves the workload twice
through the same Engine or Server (``common.compile_warm``: on the card the
first pass builds the kernels and captures the decode graphs) and the second,
warm pass is timed.  Latency columns are read off the serving telemetry's
``serve_ttft_seconds`` / ``serve_itl_seconds`` histograms of the timed pass,
batch fill off ``serve_batch_fill``.

KV-cache precision: by default the bench sweeps kv_bits in {16, 8, 4} and
reports per precision tokens/s, resident KV bytes and the slots that fit
the kv16 pool's bytes.  Quantized caches are held to the bf16-cache oracle
with the teacher-forced per-token logit tolerance (``KV_LOGIT_TOL``; or,
with ``kv_gate="tokens"``, to static = continuous tokens at that
precision), and kv4 must cut KV bytes at least 3x.  The virtual-clock columns (engine steps
for the trace, mean request latency in steps, batch fill, byte ratios) are
deterministic functions of the scheduling policy, the same on every device;
they are what the regression ledger gates (``paper/ledger.py``).

``--sla`` benches FIFO vs SLA-aware scheduling (``run_sla``: priority
classes, chunked prefill, preemption with a packed spill) on the two-class
trace; ``--paged`` the paged pool with copy-on-write prefixes against the
slot pool (``run_paged``) on the shared-prefix trace.

``--mesh DATAxMODEL`` (``mesh_spec``) serves the continuous path on a mesh
of ranks (``launch/serve.parse_mesh``: torchrun's world, one of them
without it): every row gains a per-rank KV-bytes column, the bench holds
the per-rank bytes to at least the sequence-shard degree below the whole
pool's, and the k-bit logit gate runs the sharded decode against the
unsharded bf16 oracle.  The static comparison is skipped on a mesh, as in
the reference, so ``kv_gate="tokens"`` refuses one; ``--paged`` and
``--sla`` refuse it too.  Rank 0 writes ``--json-out``; a world that
``run`` starts (a 1x1 mesh without torchrun) ends with it.

Every entry point runs on the card unless ``device`` (``--device``) says
otherwise; ``device="cpu"`` runs the plain path.  ``run(params=)`` serves a
given tree as it is (the default builds the reference's: ``lm.init_params``
at seed 0, quantized 4-bit float at block 64).

    PYTHONPATH=src python -m repro_torch.paper.serve_bench --kv-bits 4
    PYTHONPATH=src python -m repro_torch.paper.serve_bench --paged --device cpu
    PYTHONPATH=src python -m repro_torch.paper.serve_bench --sla --json-out out.json
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.configs import QuantConfig, get_arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.quantize import quantize_params
from repro_torch.paper import common
from repro_torch.serving import KV_LOGIT_TOL, Engine, Server, Telemetry, kv_oracle_logit_gap

#: the workloads draw their prompts from the first min(vocab, WORKLOAD_VOCAB)
#: token ids: the Zipf-Markov sampler holds vocab x vocab transition logits
#: (92 GB of f32 at Qwen2-7B's 152,064 ids).  The tiny family's 2,048 ids are
#: all used, as in the reference; every full-size arch's 32,000 or more are cut
WORKLOAD_VOCAB = 4096


def _workload_vocab(cfg) -> int:
    return min(cfg.vocab_size, WORKLOAD_VOCAB)


def _run_static(eng, reqs, *, num_slots):
    """Offline-oracle static serving: FIFO within same-length groups,
    batches of up to num_slots, each run to max(max_new) and truncated per
    request.  Returns ({idx: tokens}, wall_seconds)."""
    groups: dict[int, list] = {}
    for i, r in enumerate(reqs):
        groups.setdefault(len(r["prompt"]), []).append((i, r))
    t0 = time.perf_counter()
    outs = {}
    for L in sorted(groups):
        rs = groups[L]
        for b in range(0, len(rs), num_slots):
            batch = rs[b: b + num_slots]
            prompts = np.stack([r["prompt"] for _, r in batch])
            budget = max(r["max_new"] for _, r in batch)
            toks = eng.generate(prompts, budget).tolist()
            for j, (i, r) in enumerate(batch):
                outs[i] = toks[j][: r["max_new"]]
    return outs, time.perf_counter() - t0


def _run_continuous(srv, reqs):
    """Serve the trace through an existing Server (reusable once drained).
    Arrival times are rebased onto the server's virtual clock so that a warm
    second pass sees the same burst pattern."""
    clock0 = srv.steps
    t0 = time.perf_counter()
    ids = [srv.submit(r["prompt"], r["max_new"], arrival_time=clock0 + r["arrival_time"])
           for r in reqs]
    res = srv.run_until_drained()
    dt = time.perf_counter() - t0
    outs = {i: res[rid] for i, rid in enumerate(ids)}
    fin = srv.scheduler.finished[-len(reqs):]
    lat = [r.finished_at - r.arrival_time for r in fin]
    return outs, dt, {"steps": srv.steps - clock0,
                      "mean_latency_steps": float(np.mean(lat))}


def _latency_columns(tel) -> tuple[dict, str]:
    """p50/p99 TTFT and inter-token latency (ms) off the telemetry
    histograms of one timed pass: ({suffix: ms}, derived-column str)."""
    cols = {}
    for key, name in (("ttft", "serve_ttft_seconds"), ("itl", "serve_itl_seconds")):
        h = tel.registry.histogram(name)
        for p in (50, 99):
            cols[f"{key}_p{p}_ms"] = h.percentile(p) * 1e3 if h.count else float("nan")
    derived = ";".join(f"{k}={v:.2f}" for k, v in cols.items())
    return cols, derived


def _class_latency(reqs, marks) -> dict:
    """Per-priority-class p50/p99 TTFT and mean-ITL percentiles (ms) off
    the per-Request wall-clock telemetry marks of one timed pass."""
    out = {}
    for cls in sorted({r["priority"] for r in reqs}):
        idx = [i for i, r in enumerate(reqs) if r["priority"] == cls]
        ttft = [marks[i].t_first_token - marks[i].t_submit for i in idx]
        itl = [(marks[i].t_last_token - marks[i].t_first_token) / (len(marks[i].tokens) - 1)
               for i in idx if len(marks[i].tokens) > 1]
        out[cls] = {
            "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
            "ttft_p99_ms": float(np.percentile(ttft, 99) * 1e3),
            "itl_p50_ms": float(np.percentile(itl, 50) * 1e3) if itl else float("nan"),
            "itl_p99_ms": float(np.percentile(itl, 99) * 1e3) if itl else float("nan"),
        }
    return out


def _dump(json_out, log, arch, num_slots, n_requests, stats, cli_args, dev) -> None:
    path = Path(json_out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"arch": arch, "num_slots": num_slots, "n_requests": n_requests,
         "meta": common.run_meta(cli_args, dev), **stats}, indent=2))
    log(f"  stats -> {path}")


def run_sla(log=print, *, arch="tiny-160k", num_slots=4, n_requests=24, kv_bits=4,
            prefill_chunk=16, max_preemptions=2, seed=0, json_out=None, cli_args=None,
            device=None):
    """FIFO vs SLA-aware scheduling on the two-class bursty trace
    (``data/synthetic.two_class_workload``): a burst of long low-priority
    requests fills the pool, short high-priority requests trickle in behind
    it.  Both policies serve the SAME trace through the same steps; greedy
    outputs are checked token-identical per request.  Gates (the
    reference's), on the virtual clock:

    * the hi class's p99 admission wait improves at least 2x under SLA,
    * the trace takes at most FIFO's engine steps / 0.9,
    * at least one preemption,
    * spilled bytes are packed: bytes_packed / bytes_logical in
      [kv_bits/16, 1.25 kv_bits/16].

    Wall-clock latencies (per-class p50/p99 TTFT and ITL off the request
    marks) are reported."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if kv_bits < 16:
        cfg = cfg.with_kv_quant(kv_bits)
    params = lm.init_params(cfg, seed=0, device=dev)
    reqs = synthetic.two_class_workload(_workload_vocab(cfg), n_requests, seed=seed,
                                        device=dev)
    max_seq_len = max(len(r["prompt"]) + r["max_new"] for r in reqs)
    n_hi = sum(r["priority"] == 0 for r in reqs)
    log(f"  {n_requests} requests ({n_hi} hi-priority), {num_slots} slots, kv{kv_bits}, "
        f"prefill_chunk={prefill_chunk}, max_preemptions={max_preemptions}")

    def _serve(sla: bool):
        tel = Telemetry()
        srv = Server(params, cfg, num_slots=num_slots, max_seq_len=max_seq_len,
                     telemetry=tel, prefill_chunk=prefill_chunk if sla else None,
                     max_preemptions=max_preemptions if sla else 0, device=dev)

        def _pass():
            tel.reset()
            srv.pool.record_footprint()
            clock0 = srv.steps
            t0 = time.perf_counter()
            ids = [srv.submit(r["prompt"], r["max_new"],
                              arrival_time=clock0 + r["arrival_time"],
                              priority=r["priority"] if sla else 0)
                   for r in reqs]
            res = srv.run_until_drained()
            dt = time.perf_counter() - t0
            fin = {q.id: q for q in srv.scheduler.finished}
            return ({i: res[rid] for i, rid in enumerate(ids)}, dt,
                    {i: fin[rid] for i, rid in enumerate(ids)}, srv.steps - clock0)

        outs, dt, marks, vsteps = common.compile_warm(_pass)
        # best of 3 timed passes for the reported wall numbers; the serve is
        # deterministic, so the virtual steps and tokens are the same each pass
        for _ in range(2):
            o2, d2, m2, v2 = _pass()
            if o2 != outs or v2 != vsteps:
                raise AssertionError("serve is not deterministic across passes")
            if d2 < dt:
                dt, marks = d2, m2
        return outs, dt, marks, vsteps, tel

    out_f, dt_f, marks_f, v_f, _ = _serve(sla=False)
    out_s, dt_s, marks_s, v_s, tel_s = _serve(sla=True)
    mism = [i for i in range(n_requests) if out_f[i] != out_s[i]]
    if mism:
        raise AssertionError(f"greedy outputs diverge between FIFO and SLA scheduling for "
                             f"requests {mism[:5]}: policy leaked into the math")

    toks = sum(len(t) for t in out_f.values())
    tps_f, tps_s = toks / dt_f, toks / dt_s
    lat_f, lat_s = _class_latency(reqs, marks_f), _class_latency(reqs, marks_s)
    # per-trace counters come from the telemetry of the LAST pass (the
    # scheduler's own n_preemptions accumulates across passes)
    n_pre = int(tel_s.registry.counter("serve_preemptions_total").value)
    rows, stats = [], {"tok_s_fifo": tps_f, "tok_s_sla": tps_s, "kv_bits": kv_bits,
                       "n_preemptions": n_pre}
    for label, lat, tps in (("fifo", lat_f, tps_f), ("sla", lat_s, tps_s)):
        for cls, c in lat.items():
            name = "hi" if cls == 0 else "lo"
            log(f"  {label:4s} {name}: ttft p50 {c['ttft_p50_ms']:7.1f}ms "
                f"p99 {c['ttft_p99_ms']:7.1f}ms  itl p50 {c['itl_p50_ms']:6.2f}ms "
                f"p99 {c['itl_p99_ms']:6.2f}ms")
            rows.append((f"serve/{label}_{name}", c["ttft_p99_ms"] * 1e3,
                         ";".join(f"{k}={v:.2f}" for k, v in c.items()) + f";tok_s={tps:.1f}"))
            stats.update({f"{label}_{name}_{k}": v for k, v in c.items()})

    speedup = lat_f[0]["ttft_p99_ms"] / lat_s[0]["ttft_p99_ms"]

    # -- deterministic gates on the virtual clock -----------------------------
    def _hi_wait_p99(marks):
        waits = [marks[i].admitted_at - marks[i].arrival_time
                 for i, r in enumerate(reqs) if r["priority"] == 0]
        return float(np.percentile(waits, 99))

    wait_f, wait_s = _hi_wait_p99(marks_f), _hi_wait_p99(marks_s)
    log(f"  hi-priority p99 ttft {speedup:.2f}x better under SLA (virtual: {wait_f:.1f} -> "
        f"{wait_s:.1f} admission-wait steps; {n_pre} preemptions, tok/s "
        f"{tps_s / tps_f:.2f}x wall, {v_f / v_s:.2f}x virtual; outputs token-identical)")
    if n_pre < 1:
        raise AssertionError("the two-class trace never triggered a preemption")
    if not wait_s * 2.0 <= wait_f:
        raise AssertionError(f"hi-class p99 admission wait only improved {wait_f:.1f} -> "
                             f"{wait_s:.1f} steps, gate wants 2x")
    if not v_s <= v_f / 0.9:
        raise AssertionError(f"SLA used {v_s} engine steps for the trace vs FIFO's {v_f}: "
                             f"virtual throughput fell more than 10%")
    packed = tel_s.registry.counter("kv_spill_bytes_total", kind="packed").value
    logical = tel_s.registry.counter("kv_spill_bytes_total", kind="logical").value
    if kv_bits < 16:
        ratio = packed / max(logical, 1)
        log(f"  spilled {packed/1e3:.1f} kB packed of {logical/1e3:.1f} kB bf16-equivalent "
            f"({ratio:.3f}, kv_bits/16 = {kv_bits/16:.3f})")
        # packed codes are exactly kv_bits/16 of the bf16 bytes; the
        # per-block scales ride on top (one bf16 per 64-wide block)
        if not kv_bits / 16 <= ratio <= kv_bits / 16 * 1.25:
            raise AssertionError(f"spill ratio {ratio:.3f} is not packed-sized "
                                 f"(expected ~{kv_bits/16:.3f})")
        stats["spill_ratio"] = ratio
    stats.update({"ttft_speedup_hi": speedup, "hi_wait_p99_steps_fifo": wait_f,
                  "hi_wait_p99_steps_sla": wait_s, "vsteps_fifo": v_f, "vsteps_sla": v_s,
                  "spill_bytes_packed": packed, "spill_bytes_logical": logical})
    rows.append(("serve/sla_speedup", 0.0, f"x={speedup:.2f};outputs_match=1"))
    if json_out is not None:
        _dump(json_out, log, arch, num_slots, n_requests, stats, cli_args, dev)
    return rows, stats


def _run_tracked(srv, reqs):
    """Serve the trace like _run_continuous, through an explicit step loop
    that samples residency each step: returns (outs, wall_seconds, {steps,
    peak_resident, peak_pages_held}).  peak_pages_held is 0 for a slot
    pool."""
    clock0 = srv.steps
    t0 = time.perf_counter()
    ids = [srv.submit(r["prompt"], r["max_new"], arrival_time=clock0 + r["arrival_time"])
           for r in reqs]
    alloc = getattr(srv.pool, "allocator", None)
    peak_res = peak_pages = 0
    while not srv.scheduler.drained:
        if not srv.scheduler.running:
            nxt = srv.scheduler.next_arrival()
            if nxt is not None and nxt > srv.steps:
                srv.steps = int(np.ceil(nxt))
        srv.step()
        peak_res = max(peak_res, len(srv.scheduler.running))
        if alloc is not None:
            peak_pages = max(peak_pages, alloc.n_usable - alloc.n_free)
    dt = time.perf_counter() - t0
    res = {r.id: list(r.tokens) for r in srv.scheduler.finished}
    outs = {i: res[rid] for i, rid in enumerate(ids)}
    return outs, dt, {"steps": srv.steps - clock0, "peak_resident": peak_res,
                      "peak_pages_held": peak_pages}


def run_paged(log=print, *, arch="tiny-160k", num_slots=4, n_requests=12, kv_bits=4,
              page_size=8, rate=4.0, seed=0, json_out=None, cli_args=None, device=None):
    """Paged vs slot-pool serving on the shared-prefix trace
    (``data/synthetic.shared_prefix_workload``): every prompt is one of two
    shared prefixes plus a short private suffix, arriving Poisson.  Three
    serves of the same tree:

    * baseline: the slot pool, ``num_slots`` rows of ``max_seq_len``;
    * paged=: the paged pool at the SAME slot count and its default page
      budget: greedy outputs must be token-identical to the baseline;
    * paged+: the paged pool with 2x the decode rows on the baseline's token
      budget in pages (equal memory up to the one reserved trash page): it
      must hold strictly more concurrent residents than ``num_slots``, fork
      at least one copy-on-write page, and hold less memory at its peak
      than slot rows would for that residency.

    ``paged_bytes_ratio`` = peak_pages * page_size / (peak_resident *
    max_seq_len), deterministic and gated lower."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if kv_bits < 16:
        cfg = cfg.with_kv_quant(kv_bits)
    params = lm.init_params(cfg, seed=0, device=dev)
    reqs = synthetic.shared_prefix_workload(_workload_vocab(cfg), n_requests, rate=rate,
                                            seed=seed, device=dev)
    need = max(len(r["prompt"]) + r["max_new"] for r in reqs)
    max_seq_len = -(-need // page_size) * page_size
    total_tokens = sum(r["max_new"] for r in reqs)
    base_pages = num_slots * (max_seq_len // page_size)
    n_prefixes = len({r["prefix_id"] for r in reqs})
    log(f"  {n_requests} requests over {n_prefixes} shared prefixes, poisson rate {rate}/step, "
        f"kv{kv_bits}, page_size {page_size}, cache_len {max_seq_len}")

    def _serve(paged: bool, slots: int, n_pages=None):
        tel = Telemetry()
        srv = Server(params, cfg, num_slots=slots, max_seq_len=max_seq_len, telemetry=tel,
                     paged=paged, page_size=page_size, n_pages=n_pages, device=dev)

        def _pass():
            tel.reset()
            srv.pool.record_footprint()
            return _run_tracked(srv, reqs)

        outs, dt, st = common.compile_warm(_pass)
        return outs, dt, st, srv

    out_b, dt_b, st_b, srv_b = _serve(False, num_slots)
    kvb_b = srv_b.pool.kv_bytes()
    tps_b = total_tokens / dt_b
    log(f"  slot pool:   {num_slots} slots, {kvb_b['total']/1e6:7.3f} MB, {st_b['steps']} "
        f"steps, peak resident {st_b['peak_resident']}, {tps_b:8.1f} tok/s")

    # same slot count, equal token budget: the identity leg
    out_p, _, st_p, srv_p = _serve(True, num_slots)
    mism = [i for i in range(n_requests) if out_p[i] != out_b[i]]
    if mism:
        raise AssertionError(f"paged greedy outputs diverge from the slot pool for requests "
                             f"{mism[:5]}: paging leaked into the math")
    log(f"  paged=:      token-identical to the slot pool ({st_p['steps']} steps, cow_hits "
        f"{srv_p.pool.allocator.cow_hits})")

    # 2x the rows, the baseline's token budget in pages: the capacity leg
    out_e, dt_e, st_e, srv_e = _serve(True, 2 * num_slots, n_pages=base_pages + 1)
    mism = [i for i in range(n_requests) if out_e[i] != out_b[i]]
    if mism:
        raise AssertionError(f"equal-memory paged outputs diverge for requests {mism[:5]}")
    tps_e = total_tokens / dt_e
    kvb_e = srv_e.pool.kv_bytes()
    peak = st_e["peak_resident"]
    bytes_ratio = st_e["peak_pages_held"] * page_size / max(peak * max_seq_len, 1)
    cow = srv_e.pool.allocator.cow_hits
    log(f"  paged+:      {2 * num_slots} slots on the kv{kv_bits} slot-pool page budget "
        f"({base_pages} pages, {kvb_e['total']/1e6:7.3f} MB incl. trash page): peak resident "
        f"{peak} (slot pool {st_b['peak_resident']}), {st_e['steps']} steps, "
        f"{tps_e:8.1f} tok/s,\n               peak {st_e['peak_pages_held']} pages held = "
        f"{bytes_ratio:.3f} of the slot bytes for that residency, cow_hits {cow}")
    if not peak > st_b["peak_resident"]:
        raise AssertionError(f"equal-memory paged residency {peak} must beat the slot pool's "
                             f"{st_b['peak_resident']}: prefix sharing bought nothing")
    if not cow > 0:
        raise AssertionError("shared-prefix trace produced no COW forks")
    if not bytes_ratio < 1.0:
        raise AssertionError(f"paged peak bytes ratio {bytes_ratio:.3f} >= 1: paging held more "
                             f"memory than slot rows for the same residency")

    stats = {
        "kv_bits": kv_bits, "page_size": page_size,
        "paged_slots_resident": peak, "paged_bytes_ratio": bytes_ratio,
        "slots_resident_baseline": st_b["peak_resident"],
        "paged_steps": st_e["steps"], "baseline_steps": st_b["steps"],
        "paged_cow_hits": cow, "tok_s_baseline": tps_b, "tok_s_paged": tps_e,
        "kv_mb_baseline": kvb_b["total"] / 1e6, "kv_mb_paged": kvb_e["total"] / 1e6,
    }
    rows = [
        ("serve/paged_resident", float(peak),
         f"baseline={st_b['peak_resident']};pages={base_pages};cow_hits={cow}"),
        ("serve/paged_bytes_ratio", bytes_ratio,
         f"peak_pages={st_e['peak_pages_held']};page_size={page_size}"),
        ("serve/paged_tok_s", dt_e / total_tokens * 1e6,
         f"tok_s={tps_e:.1f};baseline_tok_s={tps_b:.1f}"),
    ]
    if json_out is not None:
        _dump(json_out, log, arch, num_slots, n_requests, stats, cli_args, dev)
    return rows, stats


def run(log=print, *, arch="tiny-160k", num_slots=8, n_requests=48, rate=4.0,
        max_new_range=(8, 48), quantized=True, seed=0, kv_bits=None, matmul_mode="auto",
        mesh_spec=None, json_out=None, cli_args=None, device=None, params=None,
        kv_gate="logit_gap"):
    """kv_bits: None sweeps {16, 8, 4}; an int benches that precision (the
    kv16 pool's bytes are still measured for the reduction ratio).
    matmul_mode picks the QuantizedTensor dispatch for BOTH paths and is
    reported in every row.  ``params``: a tree to serve as it is; None
    builds ``lm.init_params(cfg, seed=0)`` and, with ``quantized``, encodes
    it 4-bit float at block 64.  ``kv_gate`` holds each k-bit precision: ``"logit_gap"`` (the reference's gate) to its
    teacher-forced gap under ``KV_LOGIT_TOL``; ``"tokens"``, for an arch
    whose random weights miss that tolerance in the reference too
    (Qwen2-7B's family: scripts/kv_gap_reference.py), to static = continuous
    greedy tokens at that precision, the identity the bench holds at kv16,
    with the gap recorded.  ``mesh_spec`` ('DATAxMODEL') serves the
    continuous path on a mesh (module docstring); json_out dumps the stats
    dict."""
    if kv_gate not in ("logit_gap", "tokens"):
        raise ValueError(f"kv_gate must be logit_gap | tokens, got {kv_gate!r}")
    if mesh_spec is not None and kv_gate == "tokens":
        raise ValueError("kv_gate='tokens' holds static = continuous tokens, and the static "
                         "comparison is skipped on a mesh: use kv_gate='logit_gap'")
    import torch.distributed as dist

    from repro_torch.launch.serve import parse_mesh

    # a world this call starts (not one the caller runs in) ends with it
    started = mesh_spec is not None and not dist.is_initialized()
    mesh = parse_mesh(mesh_spec, device)
    try:
        return _run(log, mesh, arch=arch, num_slots=num_slots, n_requests=n_requests,
                    rate=rate, max_new_range=max_new_range, quantized=quantized, seed=seed,
                    kv_bits=kv_bits, matmul_mode=matmul_mode, mesh_spec=mesh_spec,
                    json_out=json_out, cli_args=cli_args, device=device, params=params,
                    kv_gate=kv_gate)
    finally:
        if started:
            dist.destroy_process_group()


def _run(log, mesh, *, arch, num_slots, n_requests, rate, max_new_range, quantized, seed,
         kv_bits, matmul_mode, mesh_spec, json_out, cli_args, device, params, kv_gate):
    """``run``'s sweep on ``mesh`` (a DeviceMesh, or None)."""
    from repro_torch.models.sharding import Sharder

    dev = resolve_device(device)
    cfg = get_arch(arch).with_matmul_mode(matmul_mode)
    if params is None:
        params = lm.init_params(cfg, seed=0, device=dev)
        if quantized:
            qcfg = QuantConfig(bits=4, dtype="float", block_size=64)
            params = quantize_params(params, qcfg, cfg, device=dev)
            log(f"  serving {arch} quantized {qcfg.describe()} (matmul_mode={matmul_mode})")
    else:
        log(f"  serving {arch} on the given tree (matmul_mode={matmul_mode})")

    reqs = synthetic.serving_workload(_workload_vocab(cfg), n_requests,
                                      max_new_range=max_new_range, rate=rate, seed=seed,
                                      device=dev)
    max_seq_len = max(len(r["prompt"]) for r in reqs) + max_new_range[1]
    total_tokens = sum(r["max_new"] for r in reqs)
    sweep = [16, 8, 4] if kv_bits is None else sorted({16, kv_bits}, reverse=True)
    log(f"  {n_requests} requests, {total_tokens} tokens, poisson rate {rate}/step, "
        f"{num_slots} slots, kv_bits sweep {sweep}")

    rows, stats = [], {}
    bytes16 = None
    for bits in sweep:
        cfg_b = cfg.with_kv_quant(bits) if bits < 16 else cfg
        sharder = None if mesh is None else Sharder(mesh, cfg_b, replicate_params_below=0)
        tel = Telemetry()
        srv = Server(params, cfg_b, num_slots=num_slots, max_seq_len=max_seq_len,
                     sharder=sharder, telemetry=tel, device=dev)
        kvb = srv.pool.kv_bytes()
        if bits == 16:
            bytes16 = kvb["total"]
        if kv_bits is not None and bits == 16 and kv_bits != 16:
            # only the byte baseline is needed; skip the 16-bit serve
            log(f"  kv16: {kvb['total']/1e6:7.3f} MB pool (byte baseline)")
            continue

        # continuous: pass 1 warms (kernels, the captured step), pass 2 is
        # timed; the telemetry reset keeps the histograms to the warm pass
        def _pass_c(srv=srv, tel=tel):
            tel.reset()
            srv.pool.record_footprint()
            return _run_continuous(srv, reqs)

        out_c, dt_c, cstats = common.compile_warm(_pass_c)
        tps_c = total_tokens / dt_c
        lat_c, lat_c_str = _latency_columns(tel)
        # virtual-clock columns: deterministic functions of the scheduling
        # policy (no EOS in the workload, so token values cannot move them);
        # the regression ledger gates on them (paper/ledger.py)
        stats[f"kv{bits}_steps"] = cstats["steps"]
        stats[f"kv{bits}_mean_latency_steps"] = cstats["mean_latency_steps"]

        if mesh is not None:
            # sequence sharding must shrink what one rank holds by at least
            # the seq-shard degree (batch sharding stacks on top)
            s_size = sharder._axis_size(sharder.decode_plan(num_slots)[1])
            dev_shrink = kvb["total"] / max(kvb["per_device"], 1)
            log(f"  kv{bits} mesh {mesh_spec}: {kvb['per_device']/1e6:.3f} MB/rank "
                f"({dev_shrink:.1f}x below the whole pool, seq shards {s_size})")
            if not dev_shrink >= s_size:
                raise AssertionError(f"per-rank KV bytes shrank only {dev_shrink:.2f}x, "
                                     f"expected >= the {s_size}-way seq-shard degree")
            stats[f"kv{bits}_dev_shrink"] = dev_shrink
            stats["seq_shards"] = s_size

        if (bits == 16 or kv_gate == "tokens") and mesh is None:
            # offline-oracle static baseline + token-identity check
            tel_s = Telemetry()
            eng = Engine(params, cfg_b, max_seq_len=max_seq_len, telemetry=tel_s, device=dev)

            def _pass_s(eng=eng, tel_s=tel_s):
                tel_s.reset()
                return _run_static(eng, reqs, num_slots=num_slots)

            out_s, dt_s = common.compile_warm(_pass_s)
            mism = [i for i in range(n_requests) if out_s[i] != out_c[i]]
            if mism:
                raise AssertionError(f"greedy outputs diverge for requests {mism[:5]} at "
                                     f"kv{bits}")
            stats[f"kv{bits}_static_equals_continuous"] = True
        if bits == 16 and mesh is None:
            tps_s = total_tokens / dt_s
            speedup = tps_c / tps_s
            lat_s, lat_s_str = _latency_columns(tel_s)
            log(f"  static:     {dt_s:.2f}s  {tps_s:8.1f} tok/s (offline-oracle grouping; "
                f"ttft p50 {lat_s['ttft_p50_ms']:.1f}ms p99 {lat_s['ttft_p99_ms']:.1f}ms, "
                f"itl p50 {lat_s['itl_p50_ms']:.2f}ms p99 {lat_s['itl_p99_ms']:.2f}ms)")
            rows.append(("serve/static", dt_s / total_tokens * 1e6,
                         f"tok_s={tps_s:.1f};mm={matmul_mode};" + lat_s_str))
            stats.update({"tok_s_static": tps_s, "speedup": speedup})
            stats.update({f"static_{k}": v for k, v in lat_s.items()})

        fill = tel.registry.histogram("serve_batch_fill").mean
        slots_equal_hbm = int(num_slots * bytes16 / max(kvb["total"], 1))
        line = (f"  kv{bits}: {dt_c:.2f}s {tps_c:8.1f} tok/s  {kvb['total']/1e6:7.3f} MB pool "
                f"({kvb['per_token']:.1f} B/token, max {slots_equal_hbm} slots in the kv16 "
                f"budget)\n        ttft p50 {lat_c['ttft_p50_ms']:.1f}ms "
                f"p99 {lat_c['ttft_p99_ms']:.1f}ms, itl p50 {lat_c['itl_p50_ms']:.2f}ms "
                f"p99 {lat_c['itl_p99_ms']:.2f}ms, batch fill {fill:.2f}")
        if bits < 16:
            ratio = bytes16 / kvb["total"]
            n_probe = min(4, n_requests)
            probe_len = min(len(r["prompt"]) for r in reqs[:n_probe])
            probe = np.stack([r["prompt"][:probe_len] for r in reqs[:n_probe]])
            gap, agree = kv_oracle_logit_gap(params, cfg_b, probe, 16, device=dev,
                                             sharder=sharder)
            tol = KV_LOGIT_TOL[bits]
            line += (f"  {ratio:.2f}x fewer KV bytes, logit gap {gap:.3f} (tol {tol}), "
                     f"greedy agree {agree:.0%}")
            stats[f"kv{bits}_ratio"] = ratio
            stats[f"kv{bits}_logit_gap"] = gap
            stats[f"kv{bits}_greedy_agree"] = agree
            stats[f"kv{bits}_gate"] = kv_gate
            if kv_gate == "tokens":
                line += ", static = continuous tokens (the gate)"
            elif not gap < tol:
                raise AssertionError(f"kv{bits} logit gap {gap:.3f} exceeds tolerance {tol}")
            if bits == 4 and not ratio >= 3.0:
                raise AssertionError(f"kv4 must cut KV bytes >= 3x vs kv16, got {ratio:.2f}x")
        log(line)
        tag = ("" if mesh is None
               else f";mesh={mesh_spec};kv_dev_mb={kvb['per_device']/1e6:.3f}")
        rows.append((f"serve/continuous_kv{bits}", dt_c / total_tokens * 1e6,
                     f"tok_s={tps_c:.1f};mm={matmul_mode};kv_mb={kvb['total']/1e6:.3f};"
                     f"slots_equal_hbm={slots_equal_hbm};" + lat_c_str + tag))
        stats[f"tok_s_kv{bits}"] = tps_c
        stats[f"kv{bits}_mb"] = kvb["total"] / 1e6
        stats[f"kv{bits}_dev_mb"] = kvb["per_device"] / 1e6
        stats.update({f"kv{bits}_{k}": v for k, v in lat_c.items()})
        stats[f"kv{bits}_batch_fill"] = fill

    stats["matmul_mode"] = matmul_mode
    if mesh_spec is not None:
        stats["mesh"] = mesh_spec
    if "speedup" in stats:
        log(f"  speedup: {stats['speedup']:.2f}x (outputs token-identical at kv16)")
        rows.append(("serve/speedup", 0.0, f"x={stats['speedup']:.2f};outputs_match=1"))
    if json_out is not None and (mesh is None or mesh.get_rank() == 0):
        _dump(json_out, log, arch, num_slots, n_requests, stats, cli_args, dev)
    return rows, stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-bits", type=int, default=None, choices=[4, 8, 16],
                    help="bench one KV precision (default: sweep 16/8/4)")
    ap.add_argument("--arch", default="tiny-160k")
    ap.add_argument("--num-slots", type=int, default=None, help="default: 8 (4 with --sla)")
    ap.add_argument("--num-requests", type=int, default=None,
                    help="default: 48 (24 with --sla)")
    ap.add_argument("--sla", action="store_true",
                    help="bench FIFO vs SLA-aware scheduling (priority classes + chunked "
                         "prefill + preemption with a packed spill) on the two-class "
                         "bursty trace instead of the static-vs-continuous sweep")
    ap.add_argument("--paged", action="store_true",
                    help="bench the paged KV cache (copy-on-write prefix sharing) vs the "
                         "slot pool on the shared-prefix Poisson trace")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per page for --paged (default 8)")
    ap.add_argument("--matmul-mode", default="auto",
                    choices=["auto", "fused", "dequant_einsum"],
                    help="QuantizedTensor matmul dispatch for both the static and "
                         "continuous paths (the mm= column of every row)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve the continuous path on a (data, model) mesh of ranks "
                         "(torchrun --nproc-per-node DATA*MODEL; a world of one "
                         "without it)")
    ap.add_argument("--json-out", default=None, metavar="PATH.json",
                    help="dump the stats dict as JSON")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.sla and args.paged:
        raise SystemExit("--sla and --paged are separate benches; pick one")
    if args.paged:
        if args.mesh is not None:
            raise SystemExit("--paged is single-device (paged serving forbids a sharder); "
                             "drop --mesh")
        run_paged(arch=args.arch,
                  num_slots=args.num_slots if args.num_slots is not None else 4,
                  n_requests=args.num_requests if args.num_requests is not None else 12,
                  kv_bits=args.kv_bits if args.kv_bits is not None else 4,
                  page_size=args.page_size, json_out=args.json_out, cli_args=vars(args),
                  device=args.device)
    elif args.sla:
        if args.mesh is not None:
            raise SystemExit("--sla is single-device (chunked prefill forbids a sharder); "
                             "drop --mesh")
        run_sla(arch=args.arch,
                num_slots=args.num_slots if args.num_slots is not None else 4,
                n_requests=args.num_requests if args.num_requests is not None else 24,
                kv_bits=args.kv_bits if args.kv_bits is not None else 4,
                json_out=args.json_out, cli_args=vars(args), device=args.device)
    else:
        run(arch=args.arch,
            num_slots=args.num_slots if args.num_slots is not None else 8,
            n_requests=args.num_requests if args.num_requests is not None else 48,
            kv_bits=args.kv_bits, matmul_mode=args.matmul_mode, mesh_spec=args.mesh,
            json_out=args.json_out, cli_args=vars(args), device=args.device)


if __name__ == "__main__":
    main()
