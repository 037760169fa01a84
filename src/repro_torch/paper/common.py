"""Shared infrastructure of the paper's experiments — port of
``benchmarks/common.py``: train the tiny model ladder, quantize and
evaluate it, time a call, stamp and write JSON results and CSV rows.

``trained_family`` trains the ladder once and caches it through the
checkpoint manager under ``artifacts/ckpt_torch/`` (as the reference caches
under ``artifacts/ckpt/``); a cache directory is keyed by the model, the
recipe and the device type, so a shortened run or a run on another device
never reads a ladder trained otherwise.  Results go to
``artifacts/bench_torch/``; both are ignored by git.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.tiny import TINY_FAMILY
from repro_torch.data.synthetic import ZipfMarkov, generator
from repro_torch.device import resolve_device
from repro_torch.models.quantize import bits_report, quantize_params
from repro_torch.serving import perplexity
from repro_torch.serving.telemetry import LATENCY_BUCKETS, Histogram
from repro_torch.train import loop
from repro_torch.train import step as step_mod
from repro_torch.tree import leaves

ART = Path(__file__).resolve().parents[3] / "artifacts"

TRAIN_RECIPE = {  # steps tuned for CPU wall-time vs. learnability
    "tiny-160k": dict(steps=260, batch=32, seq_len=128),
    "tiny-650k": dict(steps=260, batch=32, seq_len=128),
    "tiny-2.6m": dict(steps=220, batch=32, seq_len=128),
    "tiny-10m": dict(steps=160, batch=16, seq_len=128),
}


class Trained(NamedTuple):
    cfg: ArchConfig
    params: dict
    history: list    # per-step training loss


def cache_key(name: str, recipe: dict, device) -> str:
    """The cache directory's name: the model, its recipe and the device type
    (``tiny-650k-s260-b32-l128-cuda``).  The reference keys by model alone
    and takes any checkpoint at or past the recipe's steps, which would hand
    a 260-step model to a 30-step call."""
    return (f"{name}-s{recipe['steps']}-b{recipe['batch']}-l{recipe['seq_len']}"
            f"-{torch.device(device).type}")


def trained_family(sizes=None, log=print, device=None, steps: int | None = None,
                   cache_dir=None) -> dict:
    """Train (or load cached) the tiny model ladder on ``device`` (CUDA by
    default) with TRAIN_RECIPE, or ``steps`` steps each; returns {name:
    Trained}.  ``cache_dir`` (default ``ART / "ckpt_torch"``) holds one
    checkpoint directory a model and recipe (``cache_key``); a cached model
    is restored bit for bit with its loss history, else trained and saved
    there."""
    dev = resolve_device(device)
    cache_dir = Path(cache_dir) if cache_dir is not None else ART / "ckpt_torch"
    out = {}
    for name, cfg in TINY_FAMILY.items():
        if sizes and name not in sizes:
            continue
        recipe = dict(TRAIN_RECIPE[name])
        if steps is not None:
            recipe["steps"] = steps
        ckpt_dir = cache_dir / cache_key(name, recipe, dev)
        t0 = time.time()
        mgr = CheckpointManager(ckpt_dir)
        cached = mgr.latest_step()
        if cached == recipe["steps"]:
            _, state, extra = mgr.restore(step_mod.init_state(cfg, device=dev))
            hist = extra["losses"]
            log(f"[cache] {name} ({time.time()-t0:.1f}s)")
        else:
            state, hist = loop.train(cfg, log=lambda *_: None, device=dev,
                                     ckpt_dir=str(ckpt_dir), ckpt_every=10_000, **recipe)
            if cached:   # resumed a preemption save: its losses come first
                hist = mgr.restore(state)[2]["losses"]
            log(f"[train] {name}: loss {hist[0]:.3f}->{hist[-1]:.3f} "
                f"({time.time()-t0:.0f}s)")
        out[name] = Trained(cfg, state.params, hist)
    return out


def eval_tokens(cfg, n_seqs=24, seq_len=129, seed=1234, device=None):
    proc = ZipfMarkov(cfg.vocab_size, device=device)
    return proc.sample(generator(seed, proc.device), n_seqs, seq_len)


def evaluate_quant(cfg, params, qcfg, toks):
    """Returns (perplexity, bits_per_param, total_bits) for one config, on
    the device the parameters are on."""
    dev = leaves(params)[0].device
    if qcfg is None:
        n = sum(x.numel() for x in leaves(params))
        return perplexity(params, cfg, toks, device=dev), 16.0, 16.0 * n
    qp = quantize_params(params, qcfg, cfg, device=dev)
    rep = bits_report(qp)
    return (perplexity(qp, cfg, toks, device=dev), rep["avg_bits_per_param"],
            rep["total_bits_ideal"])


def _fence(result) -> None:
    """Wait for the device work behind ``result`` (the reference's
    ``block_until_ready``): ``torch.cuda.synchronize()`` for a CUDA tensor."""
    if isinstance(result, torch.Tensor) and result.device.type == "cuda":
        torch.cuda.synchronize(result.device)


def sample_times(fn, *args, repeats=30) -> Histogram:
    """Per-call wall times (one fence per call) into a serving-telemetry
    Histogram, after one warm-up call: benches and the live server share one
    sample type and its estimators (``serving/telemetry.py``)."""
    _fence(fn(*args))
    h = Histogram(LATENCY_BUCKETS)
    for _ in range(repeats):
        t0 = time.perf_counter()
        _fence(fn(*args))
        h.observe(time.perf_counter() - t0)
    return h


def timed(fn, *args, repeats=3):
    """Mean wall time per call after a warm-up (us)."""
    return sample_times(fn, *args, repeats=repeats).mean * 1e6


def timed_robust(fn, *args, repeats=30):
    """Per-call wall times, mean of the fastest half (us): preemption and
    other tenants only ever add time, so the fast half is the hardware's."""
    return sample_times(fn, *args, repeats=repeats).fastest_mean(0.5) * 1e6


def compile_warm(fn, passes: int = 2):
    """Run ``fn`` ``passes`` times and return the LAST result: the serving
    benches' two-pass idiom (the reference's).  On the port the first pass
    through a fresh Engine or Server builds the kernels and captures the
    decode graphs; the pass returned is warm.  ``fn`` must reuse the same
    instance across calls (the captured graphs live per instance)."""
    r = None
    for _ in range(passes):
        r = fn()
    return r


def run_meta(cli_args: dict | None = None, device=None) -> dict:
    """Provenance stamp of a bench JSON: the commit, torch and CUDA versions,
    and the device (CUDA unless ``device`` says otherwise) with, on a card,
    its name and power limit."""
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ART.parent, capture_output=True,
                             text=True, timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    dev = torch.device(device if device is not None else "cuda")
    meta = {"git_sha": sha, "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda, "platform": dev.type,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "args": dict(cli_args) if cli_args else {}}
    if dev.type == "cuda":
        meta["device_kind"] = torch.cuda.get_device_name(dev)
        meta["n_devices"] = torch.cuda.device_count()
        try:
            meta["power_limit"] = subprocess.run(
                ["nvidia-smi", "-i", str(dev.index or 0), "--query-gpu=power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            meta["power_limit"] = "unknown"
    else:
        meta["device_kind"], meta["n_devices"] = "cpu", 1
    return meta


def emit(rows):
    """CSV rows: name,us_per_call,derived."""
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


def save_json(name, obj):
    p = ART / "bench_torch"
    p.mkdir(parents=True, exist_ok=True)
    with open(p / f"{name}.json", "w") as f:
        json.dump(obj, f, indent=1, default=float)
