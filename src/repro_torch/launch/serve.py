"""Serving launcher — port of ``repro/launch/serve.py``: build or load a
model, quantize it per the paper's recommendation (4-bit float, block 64 —
§7) or a mixed-precision ``--plan plan.json`` (precision/), and serve
requests, on CUDA unless ``--device`` says otherwise.

Two modes:

* ``--mode continuous`` (default) — drive a Poisson-arrival mixed-length
  workload (data/synthetic.serving_workload) through the continuous-
  batching Server: per-request admission into KV slots, mid-flight
  prefill, per-slot retirement, streamed token callbacks.

      PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-2.6m \
          --bits 4 --dtype float --num-slots 8 --num-requests 32 \
          --rate 2.0 --max-new 48

  ``--priorities K`` draws each request's class from [0, K) (0 = most
  urgent), ``--prefill-chunk C`` interleaves long prompt prefills with
  decode steps in C-token chunks (a multiple of 128 on the card), and
  ``--max-preemptions P`` (needs ``--priorities >= 2``) lets urgent
  arrivals evict lower-priority victims by spilling their packed KV rows
  to host — all three are token-identical to the plain FIFO serve.
  ``--paged`` swaps the slot pool for the paged KV cache with
  copy-on-write prefix sharing (``--page-size T``, default 16; ``--pages
  N``, default the slot pool's token capacity); token-identical to the
  slot pool, exclusive with --prefill-chunk.

* ``--mode static`` — the same-length batch path (Engine).

      PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-2.6m \
          --mode static --batch 8 --prompt-len 32 --max-new 32

A mixed-precision plan (the ``plan`` suite of ``repro_torch.paper.run``
writes ``artifacts/plans/tiny-2.6m.json``; a plan saved by the reference
loads too) serves with

      PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-2.6m \
          --plan artifacts/plans/tiny-2.6m.json

Telemetry: ``--metrics-out metrics.prom`` and/or ``--trace-out
trace.jsonl`` swap the default no-op recorder for a recording
``Telemetry`` — the serve then prints a p50/p99 TTFT and inter-token-
latency summary and dumps the Prometheus text exposition / the JSONL span
trace (validate it with ``python -m repro_torch.serving.trace
trace.jsonl``).  ``--kv-probe-every N`` additionally measures the
append-quantize roundtrip error of every Nth admission's K/V rows
(continuous mode, quantized cache only).  ``--profile`` (with a sink)
attaches the step profiler (serving/profiler.py): each serving program is
costed once and its measured step times attributed against the H100's
roofline; the serve prints a per-program summary and the metrics dump
carries the ``profile_*`` families.

Flag pairings are validated up front, by the reference's rules
(``validate_flags``): ``--plan`` carries the full weight quantization
config (conflicts with --bits/--dtype/--block-size/--outlier-pct),
``--dtype fp16`` skips weight quantization entirely (conflicts with the
same three), ``--kv-block-size/--kv-dtype`` need ``--kv-bits < 16``,
``--kv-probe-every`` needs a quantized cache plus a telemetry sink, and
each mode rejects the other's workload flags.  ``--device`` is the port's
only addition.

``--mesh DATAxMODEL`` serves on a ("data", "model") mesh of ranks, one
process a rank (``launch/mesh.py``), started by torchrun::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch tiny-650k --mesh 1x2 --kv-bits 4 --device cpu

(NCCL on the card, a card a rank; gloo on the CPU).  DATA x MODEL must be
the world's size; a world of one (``--mesh 1x1``) also starts without
torchrun.  As in the reference, an explicit mesh shards even a model
under the replication threshold (``replicate_params_below=0``).  An encoder-decoder arch (seamless-m4t-large-v2)
is refused before anything is built: it runs through ``models/seq2seq.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import QuantConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_world, make_mesh
from repro_torch.models import blocks, lm
from repro_torch.models.sharding import Sharder
from repro_torch.models.quantize import bits_report, quantize_params, quantize_tree
from repro_torch.precision import PrecisionPlan
from repro_torch.serving import NOOP, Engine, Server, StepProfiler, Telemetry
from repro_torch.serving.engine import fence
from repro_torch.serving.telemetry import record_quant_health
from repro_torch.train import step as step_mod

_STATIC_ONLY = ("batch", "prompt_len")
_CONTINUOUS_ONLY = ("num_slots", "num_requests", "rate", "prefill_chunk",
                    "priorities", "max_preemptions", "page_size", "pages")


def load_params(cfg, ckpt_dir, device=None):
    """The params of the latest checkpoint in ``ckpt_dir`` (the port's
    CheckpointManager, the reference's keys), on ``device``."""
    mgr = CheckpointManager(ckpt_dir)
    restored = mgr.restore(step_mod.init_state(cfg, device=device))
    if restored is None:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    _, state, _ = restored
    return state.params


def parse_mesh(spec: str | None, device=None):
    """'DxM' -> a ("data", "model") mesh over the world of ranks (torchrun's;
    a world of one without it), after joining it; None -> None."""
    if spec is None:
        return None
    try:
        d, m = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DATAxMODEL (e.g. 2x4), got {spec!r}")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if d * m != world:
        raise SystemExit(
            f"--mesh {spec} needs {d * m} ranks but the world has {world} (start "
            f"them with torchrun --nproc-per-node {d * m} -m repro_torch.launch.serve)"
        )
    kind = torch.device(device or "cuda").type
    if "WORLD_SIZE" in os.environ:
        init_world(kind)
    else:
        init_world(kind, rank=0, world=1,
                   init_file=os.path.join(tempfile.mkdtemp(), "rendezvous"))
    return make_mesh(d, m, kind)


def validate_flags(args) -> None:
    """Audit every flag pairing BEFORE any model work: each combination
    must either compose or fail loudly here.  The reference's rules, word
    for word, then the port's: --device names cuda or cpu."""
    quant_flags = [f for f in ("bits", "dtype", "block_size", "outlier_pct")
                   if getattr(args, f) is not None]
    if args.plan is not None and quant_flags:
        raise SystemExit(
            f"--plan carries the quantization config; drop "
            f"--{'/--'.join(f.replace('_', '-') for f in quant_flags)} "
            "(per-matrix settings live in the plan JSON)"
        )
    if args.dtype == "fp16":
        others = [f for f in quant_flags if f != "dtype"]
        if others:
            raise SystemExit(
                "--dtype fp16 skips weight quantization entirely; "
                f"--{'/--'.join(f.replace('_', '-') for f in others)} "
                "would be silently ignored — drop them or pick a "
                "quantized --dtype"
            )
    if args.kv_bits == 16 and (args.kv_block_size is not None
                               or args.kv_dtype is not None):
        raise SystemExit(
            "--kv-block-size/--kv-dtype configure the quantized KV cache; "
            "they need --kv-bits 4 or 8 (at 16 the cache stays bf16 and "
            "they would be silently ignored)"
        )
    if args.kv_probe_every is not None:
        if args.kv_probe_every < 1:
            raise SystemExit("--kv-probe-every wants a positive admission "
                             f"stride, got {args.kv_probe_every}")
        if args.kv_bits == 16:
            raise SystemExit(
                "--kv-probe-every measures the append-quantize roundtrip "
                "error of the packed KV cache; it needs --kv-bits 4 or 8 "
                "(a bf16 cache has nothing to probe)"
            )
        if args.metrics_out is None and args.trace_out is None:
            raise SystemExit(
                "--kv-probe-every records kv_append_qerr_* gauges but no "
                "telemetry sink is configured — add --metrics-out (and/or "
                "--trace-out) or drop the probe"
            )
    if args.mode == "static":
        bad = [f for f in _CONTINUOUS_ONLY if getattr(args, f) is not None]
        if args.stream:
            bad.append("stream")
        if args.paged:
            bad.append("paged")
        if args.kv_probe_every is not None:
            bad.append("kv_probe_every")
        if bad:
            raise SystemExit(
                f"--{'/--'.join(f.replace('_', '-') for f in bad)} are "
                "continuous-mode flags; static mode sizes its batch with "
                "--batch/--prompt-len/--max-new (or drop --mode static)"
            )
    else:
        bad = [f for f in _STATIC_ONLY if getattr(args, f) is not None]
        if bad:
            raise SystemExit(
                f"--{'/--'.join(f.replace('_', '-') for f in bad)} are "
                "static-mode flags; continuous mode sizes the workload "
                "with --num-slots/--num-requests/--max-new (or pass "
                "--mode static)"
            )
    if args.profile and args.metrics_out is None and args.trace_out is None:
        raise SystemExit(
            "--profile attributes step times against per-program "
            "FLOP/byte costs into profile_* gauges, but no telemetry "
            "sink is configured — add --metrics-out (and/or --trace-out) "
            "or drop --profile"
        )
    if args.prefill_chunk is not None and args.prefill_chunk < 1:
        raise SystemExit("--prefill-chunk wants a positive chunk length, "
                         f"got {args.prefill_chunk}")
    if not args.paged and (args.page_size is not None
                           or args.pages is not None):
        raise SystemExit(
            "--page-size/--pages configure the paged KV cache; they need "
            "--paged (the slot pool has no pages)"
        )
    if args.paged:
        if args.prefill_chunk is not None:
            raise SystemExit(
                "--paged and --prefill-chunk are mutually exclusive (the "
                "chunk workspace commits whole slot rows; pick one)"
            )
        if args.mesh is not None:
            raise SystemExit(
                "--paged serving is single-host for now; drop --mesh"
            )
        if args.page_size is not None and args.page_size < 1:
            raise SystemExit("--page-size wants a positive token count, "
                             f"got {args.page_size}")
        if args.pages is not None and args.pages < 2:
            raise SystemExit("--pages wants >= 2 (page 0 is the reserved "
                             f"trash page), got {args.pages}")
    if args.temperature < 0.0:
        raise SystemExit("--temperature must be >= 0 (0 samples greedily), "
                         f"got {args.temperature}")
    if args.ckpt_dir is not None and not os.path.isdir(args.ckpt_dir):
        raise SystemExit(
            f"--ckpt-dir {args.ckpt_dir} is not a directory; point it at a "
            "CheckpointManager dir (or drop it for random init)"
        )
    if args.priorities is not None and args.priorities < 1:
        raise SystemExit("--priorities wants at least one class, "
                         f"got {args.priorities}")
    if args.max_preemptions is not None:
        if args.max_preemptions < 0:
            raise SystemExit("--max-preemptions must be >= 0, "
                             f"got {args.max_preemptions}")
        if args.max_preemptions > 0 and (args.priorities is None
                                         or args.priorities < 2):
            raise SystemExit(
                "--max-preemptions > 0 evicts a strictly lower-priority "
                "victim, which needs --priorities >= 2 (a single class "
                "can never preempt itself)"
            )
    # the port's rules, after every rule the reference applies
    if args.device is not None:
        try:
            kind = torch.device(args.device).type
        except RuntimeError:
            kind = None
        if kind not in ("cuda", "cpu"):
            raise SystemExit(
                f"--device wants cuda, cuda:N or cpu (the kernels run on the "
                f"card, their plain versions on the CPU), got {args.device!r}"
            )


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--ckpt-dir", default=None, help="default: random init")
    # quantization flags default to None so --plan / --dtype fp16 can
    # reject explicit conflicts loudly instead of silently ignoring them
    ap.add_argument("--bits", type=int, default=None, help="default: 4")
    ap.add_argument("--dtype", default=None,
                    choices=["int", "float", "dynamic", "quantile", "fp16"],
                    help="default: float")
    ap.add_argument("--block-size", type=int, default=None, help="default: 64")
    ap.add_argument("--outlier-pct", type=float, default=None,
                    help="default: 0")
    ap.add_argument("--plan", default=None, metavar="PATH.json",
                    help="mixed-precision PrecisionPlan (precision/plan.py; "
                         "build with the plan suite of repro_torch.paper.run "
                         "or repro_torch.precision.build_plan; a plan saved "
                         "by the reference loads too). The plan carries the "
                         "full per-matrix quantization config — mutually "
                         "exclusive with --bits/--dtype/--block-size/"
                         "--outlier-pct.")
    ap.add_argument("--matmul-mode", default="auto",
                    choices=["auto", "fused", "dequant_einsum"],
                    help="QuantizedTensor matmul dispatch: fused streams "
                         "packed codes + scales into the dequant-GEMM "
                         "(the CUDA kernels on the card, their plain "
                         "versions on the CPU); dequant_einsum is the "
                         "16-bit-transient oracle path; auto resolves per "
                         "matrix")
    ap.add_argument("--kv-bits", type=int, default=16, choices=[4, 8, 16],
                    help="KV-cache precision: 16 = bf16 cache, 8/4 = "
                         "blockwise-quantized packed cache")
    ap.add_argument("--kv-block-size", type=int, default=None,
                    help="default: 64 (needs --kv-bits < 16)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["int", "float", "dynamic"],
                    help="default: float (needs --kv-bits < 16)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on a (data, model) mesh of DATA x MODEL ranks, "
                         "started by torchrun --nproc-per-node DATA*MODEL "
                         "(a world of one without it)")
    ap.add_argument("--mode", choices=["continuous", "static"],
                    default="continuous")
    # static-mode flags (None = unset, so continuous mode can reject
    # them loudly instead of silently ignoring a legacy invocation)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    # continuous-mode workload (Poisson arrivals, mixed lengths); None
    # defaults let static mode reject them symmetrically
    ap.add_argument("--num-slots", type=int, default=None, help="default: 8")
    ap.add_argument("--num-requests", type=int, default=None,
                    help="default: 32")
    ap.add_argument("--rate", type=float, default=None,
                    help="mean request arrivals per engine step "
                         "(default: 2.0)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="C",
                    help="split long prompt prefills into C-token chunks "
                         "interleaved with decode steps (continuous mode; "
                         "token-identical to plain prefill — "
                         "docs/serving.md#sla-scheduler)")
    ap.add_argument("--priorities", type=int, default=None, metavar="K",
                    help="draw each request's priority class uniformly "
                         "from [0, K); class 0 is most urgent and admits "
                         "first (continuous mode; default: 1 class)")
    ap.add_argument("--max-preemptions", type=int, default=None, metavar="P",
                    help="let an urgent arrival evict a lower-priority "
                         "running request up to P times per victim, "
                         "spilling its packed KV rows to host and "
                         "restoring them bit-exactly later (continuous "
                         "mode; needs --priorities >= 2; default: 0 = "
                         "never preempt)")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV cache: a global "
                         "page pool with refcounted copy-on-write prefix "
                         "sharing instead of per-slot rows (continuous "
                         "mode, full-attention archs, single host; "
                         "token-identical to the slot pool — "
                         "docs/serving.md#paged-kv-cache)")
    ap.add_argument("--page-size", type=int, default=None, metavar="T",
                    help="tokens per KV page (needs --paged; default 16, "
                         "power of two dividing the cache length)")
    ap.add_argument("--pages", type=int, default=None, metavar="N",
                    help="global page-pool size incl. the reserved trash "
                         "page (needs --paged; default: the slot pool's "
                         "token capacity)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens of the first request as they land")
    # telemetry sinks (docs/observability.md); either flag swaps the
    # no-op recorder for a recording Telemetry
    ap.add_argument("--metrics-out", default=None, metavar="PATH.prom",
                    help="write the Prometheus text exposition of the "
                         "serve's metrics registry here")
    ap.add_argument("--trace-out", default=None, metavar="PATH.jsonl",
                    help="write the per-request span trace (JSONL, schema "
                         "in serving/trace.py) here")
    ap.add_argument("--kv-probe-every", type=int, default=None, metavar="N",
                    help="measure the append-quantize roundtrip error of "
                         "every Nth admission's K/V rows (continuous mode; "
                         "needs --kv-bits < 16 and a telemetry sink)")
    ap.add_argument("--profile", action="store_true",
                    help="attach the step profiler (serving/profiler.py): "
                         "cost each serving program once, attribute its "
                         "measured step times against the roofline, print "
                         "a per-program summary and export profile_* "
                         "gauges (needs a telemetry sink)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def _finish_telemetry(tel, args) -> None:
    """Print the latency summary and flush the configured sinks."""
    if not tel.enabled:
        return
    parts = []
    for label, name in (("ttft", "serve_ttft_seconds"),
                        ("itl", "serve_itl_seconds")):
        h = tel.registry.histogram(name)
        if h.count:
            parts.append(f"{label} p50 {h.percentile(50) * 1e3:.1f}ms "
                         f"p99 {h.percentile(99) * 1e3:.1f}ms")
    if parts:
        print("telemetry: " + "; ".join(parts))
    if tel.profiler is not None:
        print(tel.profiler.format_summary())
    qerr = tel.registry.gauge("kv_append_qerr_rms")
    if tel.kv_probe_every and qerr.value:
        print(f"kv append-quantize probe: rms {qerr.value:.4f} "
              f"(max {tel.registry.gauge('kv_append_qerr_max').value:.4f})")
    tel.write(metrics_out=args.metrics_out, trace_out=args.trace_out)
    if args.metrics_out:
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        n = len(tel.tracer.events)
        print(f"trace -> {args.trace_out} ({n} events; validate with "
              f"python -m repro_torch.serving.trace {args.trace_out})")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    validate_flags(args)
    mesh = parse_mesh(args.mesh, args.device)
    try:
        _serve(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist

        if dist.get_rank():   # every rank serves; rank 0 reports
            sys.stdout = open(os.devnull, "w")
    dev = resolve_device(args.device)
    telemetry = NOOP
    if args.metrics_out is not None or args.trace_out is not None:
        telemetry = Telemetry(
            kv_probe_every=args.kv_probe_every
            if args.kv_probe_every is not None else 0,
            profiler=StepProfiler() if args.profile else None)

    cfg = get_arch(args.arch).with_matmul_mode(args.matmul_mode)
    blocks.check_dense(cfg)   # before anything is built
    if args.matmul_mode != "auto":
        print(f"matmul mode: {args.matmul_mode}")
    if args.kv_bits < 16:
        kv_bs = args.kv_block_size if args.kv_block_size is not None else 64
        kv_dt = args.kv_dtype if args.kv_dtype is not None else "float"
        cfg = cfg.with_kv_quant(args.kv_bits, block_size=kv_bs, dtype=kv_dt)
        print(f"kv cache: {kv_dt}{args.kv_bits}-b{kv_bs}")
    # an explicit --mesh asks for real sharding even below the
    # replicate-small-models threshold (that is the point of the flag)
    sharder = Sharder(mesh, cfg, replicate_params_below=0) if mesh is not None else None
    if mesh is not None:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    if args.ckpt_dir:
        params = load_params(cfg, args.ckpt_dir, device=dev)
    else:
        params = lm.init_params(cfg, seed=0, device=dev)

    if args.plan is not None:
        plan = PrecisionPlan.load(args.plan)
        # quant-health snapshot wants the raw tree (bits + blockwise qerr
        # per matrix); afterwards the Engine/Server only sees bits
        record_quant_health(telemetry, params, cfg, plan=plan)
        params = quantize_tree(params, cfg, plan=plan, device=dev)
        rep = bits_report(params)
        print(f"quantized per plan {args.plan} ({plan.describe()}): "
              f"{rep['avg_bits_per_param']:.2f} bits/param, "
              f"{rep['total_bits_ideal']/8e9:.3f} GB ideal")
    elif args.dtype != "fp16":
        qcfg = QuantConfig(bits=args.bits if args.bits is not None else 4,
                           dtype=args.dtype if args.dtype is not None else "float",
                           block_size=args.block_size
                           if args.block_size is not None else 64,
                           outlier_pct=args.outlier_pct
                           if args.outlier_pct is not None else 0.0)
        record_quant_health(telemetry, params, cfg, qcfg=qcfg)
        params = quantize_params(params, qcfg, cfg, device=dev)
        rep = bits_report(params)
        print(f"quantized {qcfg.describe()}: "
              f"{rep['avg_bits_per_param']:.2f} bits/param, "
              f"{rep['total_bits_ideal']/8e9:.3f} GB ideal")

    if args.mode == "static":
        batch = args.batch if args.batch is not None else 8
        prompt_len = args.prompt_len if args.prompt_len is not None else 32
        engine = Engine(params, cfg, max_seq_len=prompt_len + args.max_new,
                        sharder=sharder, telemetry=telemetry, device=dev)
        proc = synthetic.ZipfMarkov(cfg.vocab_size, device=dev)
        prompts = proc.sample(synthetic.generator(1, dev), batch, prompt_len)
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.max_new,
                              temperature=args.temperature)
        fence(out)
        dt = time.perf_counter() - t0
        toks = out.numel()
        print(f"generated {toks} tokens in {dt:.2f}s "
              f"({toks/dt:.1f} tok/s batched)")
        print("sample:", out[0].tolist())
        _finish_telemetry(telemetry, args)
        return

    # continuous: Poisson-arrival mixed-length stream through the slot pool
    num_slots = args.num_slots if args.num_slots is not None else 8
    num_requests = args.num_requests if args.num_requests is not None else 32
    rate = args.rate if args.rate is not None else 2.0
    priorities = args.priorities if args.priorities is not None else 1
    max_preemptions = (args.max_preemptions
                       if args.max_preemptions is not None else 0)
    reqs = synthetic.serving_workload(
        cfg.vocab_size, num_requests,
        max_new_range=(max(1, args.max_new // 4), args.max_new),
        rate=rate, priorities=priorities, device=dev,
    )
    max_seq_len = max(len(r["prompt"]) for r in reqs) + args.max_new
    page_size = args.page_size if args.page_size is not None else 16
    if args.paged:
        # pages must tile the cache budget exactly
        max_seq_len = -(-max_seq_len // page_size) * page_size
    server = Server(params, cfg, num_slots=num_slots,
                    max_seq_len=max_seq_len, sharder=sharder, telemetry=telemetry,
                    prefill_chunk=args.prefill_chunk,
                    max_preemptions=max_preemptions,
                    paged=args.paged, page_size=page_size,
                    n_pages=args.pages, device=dev)
    if args.paged:
        a = server.pool.allocator
        print(f"paged kv cache: {a.n_usable} pages x {page_size} tokens "
              f"(+1 trash), {server.pool.kv_bytes()['total']/1e6:.3f} MB")
    if priorities > 1 or args.prefill_chunk is not None:
        print(f"scheduler: {priorities} priority classes, "
              f"prefill chunk {args.prefill_chunk or 'off'}, "
              f"max preemptions {max_preemptions}")
    if sharder is not None:
        kvb = server.pool.kv_bytes()
        print(f"kv pool: {kvb['total']/1e6:.3f} MB total, "
              f"{kvb['per_device']/1e6:.3f} MB/device")
    first_id = None
    t0 = time.perf_counter()
    for r in reqs:
        stream = None
        if args.stream and first_id is None:
            stream = lambda rid, tok: print(f"  [req {rid}] {tok}", flush=True)  # noqa: E731
        rid = server.submit(r["prompt"], r["max_new"],
                            temperature=args.temperature,
                            arrival_time=r["arrival_time"],
                            priority=r.get("priority", 0),
                            on_token=stream)
        if first_id is None:
            first_id = rid
    results = server.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(t) for t in results.values())
    lat = [r.finished_at - r.arrival_time for r in server.scheduler.finished]
    print(f"served {len(reqs)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s continuous, {server.steps} engine steps, "
          f"{server.scheduler.n_preemptions} preemptions)")
    print(f"latency (engine steps): mean {np.mean(lat):.1f} "
          f"p95 {np.percentile(lat, 95):.1f}")
    if args.paged:
        a = server.pool.allocator
        print(f"paged: {a.cow_hits} cow forks, {a.alloc_total} pages "
              f"allocated / {a.freed_total} freed "
              f"({a.n_free}/{a.n_usable} free at drain)")
    print("sample:", results[first_id])
    _finish_telemetry(telemetry, args)


if __name__ == "__main__":
    main()
