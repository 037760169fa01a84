#!/usr/bin/env python3
"""Repeat, in one process on the card, the sequences of CUDA-graph captures
that came before the port's two captured cuBLAS failures (ROADMAP C5:
``CUBLAS_STATUS_EXECUTION_FAILED`` in ``cublasSgemmStridedBatched`` while a
routed-read Server captured its step), and print one JSON line an attempt.

An attempt runs the chosen sequences, then the captures that failed:

* ``audit``: reprolint's captured-graph auditor over its tiny-160k grid
  (``analysis/audit.run_audit``: 18 captures kept with their node lists),
  as chip_smoke's audit phase ran before the failure of one run;
* ``phases``: Qwen2-7B at full width and depth (4-bit float, block 64; the
  tree built once) through the Engine at batch 4 and the slot, chunked and
  paged Servers at kv4, each capturing its step and serving a few
  requests, as the serve, server and paged phases ran before the other;
* ``gc``: the routed captures below, each captured decode step made to
  drop a recorded CUDA event held in a reference cycle and to run the
  garbage collector, so that an event is destroyed while a step is
  captured;
* then the routed captures (chip_smoke's routed phase): tiny-10m's Engine at
  kv4 and kv8 and its Server on slots and on pages at kv4, whose captured
  steps run the routed read's f32 batched products (``attention._partials``)
  through cuBLAS.

With ``--keep`` every Engine and Server of every attempt stays alive, so
the live graphs and their private memory pools pile up across attempts.  A
failed capture is not retried: the attempt's line says what failed, the
error is raised and the script exits non-zero.

Run:  PYTHONPATH=src python3 scripts/capture_stress.py [--repeats 20]
          [--sequences audit,phases] [--keep] [--out build/capture_stress.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

QWEN = "qwen2-7b"
ROUTED = "tiny-10m"
SEQUENCES = ("audit", "phases", "gc")


def _requests(vocab: int, n: int, lens: tuple, new: tuple, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(0, vocab, int(rng.integers(lens[0], lens[1] + 1))),
             "max_new": int(rng.integers(new[0], new[1] + 1)),
             "arrival_time": float(i // 2)} for i in range(n)]


def _serve(srv, reqs) -> int:
    for r in reqs:
        srv.submit(r["prompt"], r["max_new"], arrival_time=r["arrival_time"])
    return sum(len(t) for t in srv.run_until_drained().values())


def _quantized(torch, name: str, dev):
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params

    cfg = get_arch(name)
    params = lm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                              device=dev)
    del params
    torch.cuda.synchronize()
    return cfg, qparams


def phases(torch, dev, tree, kept: list) -> int:
    """Qwen2-7B's Engine and slot, chunked and paged Servers: 4 programs,
    each one capture."""
    from repro_torch.serving import Engine, Server

    base, qparams = tree
    cfg = base.with_kv_quant(4)
    prompts = torch.randint(0, cfg.vocab_size, (4, 256), device=dev)
    eng = Engine(qparams, cfg, max_seq_len=272, device=dev)
    eng.generate(prompts, 8)
    kept.append(eng)
    reqs = _requests(cfg.vocab_size, 8, (16, 300), (4, 12), seed=1)
    for kw in ({}, {"prefill_chunk": 128}, {"paged": True, "page_size": 16}):
        srv = Server(qparams, cfg, num_slots=8, max_seq_len=320, device=dev, **kw)
        _serve(srv, reqs)
        kept.append(srv)
    return 4


def routed(torch, dev, tree, kept: list) -> int:
    """tiny-10m's Engine at kv4 and kv8 and Server on slots and pages at
    kv4, as chip_smoke's routed phase: 4 programs, each one capture."""
    from repro_torch.serving import Engine, Server

    base, qparams = tree
    prompts = torch.randint(0, base.vocab_size, (4, 64), device=dev)
    for kv in (4, 8):
        eng = Engine(qparams, base.with_kv_quant(kv), max_seq_len=96, device=dev)
        eng.generate(prompts, 32)
        kept.append(eng)
    cfg = base.with_kv_quant(4)
    reqs = _requests(cfg.vocab_size, 12, (16, 200), (8, 32), seed=2)
    for kw in ({}, {"paged": True, "page_size": 16}):
        srv = Server(qparams, cfg, num_slots=4, max_seq_len=256, device=dev, **kw)
        _serve(srv, reqs)
        kept.append(srv)
    return 4


def gc_during_capture(torch, dev, tree, kept) -> int:
    """The routed captures, each of whose captured decode steps first drops
    the last reference to a recorded CUDA event held in a reference cycle
    and runs the garbage collector, so that an event is destroyed while a
    step is captured (chip_smoke times with events everywhere, and any
    Python allocation inside a captured body can start a collection)."""
    import gc

    from repro_torch.models import lm

    pending = []
    for _ in range(64):
        box = {"event": torch.cuda.Event(enable_timing=True)}
        box["event"].record()
        box["self"] = box
        pending.append(box)
    torch.cuda.synchronize()
    real = lm.decode_step

    def decode_step(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing() and pending:
            pending.pop()
            gc.collect()
        return real(*args, **kwargs)

    lm.decode_step = decode_step
    try:
        return routed(torch, dev, tree, kept)
    finally:
        lm.decode_step = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--sequences", default="audit,phases",
                    help=f"comma list of {','.join(SEQUENCES)} run before the routed "
                         f"captures each attempt")
    ap.add_argument("--keep", action="store_true",
                    help="keep every Engine and Server alive across attempts")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    sequences = [s for s in args.sequences.split(",") if s]
    unknown = sorted(set(sequences) - set(SEQUENCES))
    if unknown:
        ap.error(f"unknown sequence(s) {unknown}; valid: {SEQUENCES}")

    import torch

    if not torch.cuda.is_available():
        print("capture_stress: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from repro_torch.analysis import audit
    from repro_torch.kernels import _build

    _build.build(["qgemv_sm90", "qmatmul", "qgemm_sm90", "kv_dequant", "quantize",
                  "quantize_pack", "kv_decode_attention"])
    out = open(args.out, "a") if args.out else None
    t0 = time.perf_counter()
    trees = {"routed": _quantized(torch, ROUTED, dev)}
    if "phases" in sequences:
        trees["phases"] = _quantized(torch, QWEN, dev)
    setup_s = time.perf_counter() - t0
    kept, captures = [], 0
    try:
        with tempfile.TemporaryDirectory() as dots:
            for attempt in range(args.repeats):
                line = {"attempt": attempt, "sequences": sequences + ["routed"],
                        "keep": args.keep, "setup_s": setup_s}
                t1 = time.perf_counter()
                stage = None
                try:
                    mine: list = []
                    for stage in sequences + ["routed"]:
                        if stage == "audit":
                            report = audit.run_audit(device=dev, dot_dir=Path(dots))
                            if not report.ok:
                                raise RuntimeError(f"audit failed: {report.failures()[:3]}")
                            captures += len({c.program for c in report.checks})
                        elif stage == "phases":
                            captures += phases(torch, dev, trees["phases"], mine)
                        elif stage == "gc":
                            captures += gc_during_capture(torch, dev, trees["routed"], mine)
                        else:
                            captures += routed(torch, dev, trees["routed"], mine)
                    torch.cuda.synchronize()
                except Exception as e:
                    line.update(ok=False, failed_stage=stage, error=f"{type(e).__name__}: {e}"[:2000])
                    raise
                else:
                    line["ok"] = True
                finally:
                    if args.keep:
                        kept.extend(mine)
                    line.update(seconds=time.perf_counter() - t1, programs_so_far=captures,
                                live_servers_and_engines=len(kept) if args.keep else len(mine),
                                memory_reserved=torch.cuda.memory_reserved(),
                                memory_allocated=torch.cuda.memory_allocated())
                    text = json.dumps(line)
                    print(text, flush=True)
                    if out is not None:
                        out.write(text + "\n")
                        out.flush()
                del mine
    finally:
        if out is not None:
            out.close()
    print(json.dumps({"done": True, "attempts": args.repeats, "programs": captures,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
