"""Shared infrastructure of the paper's experiments — port of
``benchmarks/common.py``: train the tiny model ladder, quantize and
evaluate it, write JSON results.

The ladder is trained on the device at every call (``trained_family``);
the reference's checkpoint cache comes with the checkpoint manager (ROADMAP
queue A9).  Results go to ``artifacts/bench_torch/`` (ignored by git).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.tiny import TINY_FAMILY
from repro_torch.data.synthetic import ZipfMarkov, generator
from repro_torch.models.quantize import bits_report, quantize_params
from repro_torch.serving import perplexity
from repro_torch.train import loop
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


def trained_family(sizes=None, log=print, device=None, steps: int | None = None) -> dict:
    """Train the tiny model ladder on ``device`` (CUDA by default) with
    TRAIN_RECIPE, or ``steps`` steps each; returns {name: Trained}."""
    out = {}
    for name, cfg in TINY_FAMILY.items():
        if sizes and name not in sizes:
            continue
        recipe = dict(TRAIN_RECIPE[name])
        if steps is not None:
            recipe["steps"] = steps
        t0 = time.time()
        state, hist = loop.train(cfg, log=lambda *_: None, device=device, **recipe)
        log(f"[train] {name}: loss {hist[0]:.3f}->{hist[-1]:.3f} ({time.time()-t0:.0f}s)")
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


def save_json(name, obj):
    p = ART / "bench_torch"
    p.mkdir(parents=True, exist_ok=True)
    with open(p / f"{name}.json", "w") as f:
        json.dump(obj, f, indent=1, default=float)
