"""Roofline analysis: per (arch x shape x mesh) terms from the dry-run's
records, plus an ANALYTIC memory floor per cell — port of
``benchmarks/roofline.py``.

Three terms (a rank, H100 SXM data-sheet rates: ``device.py``):
  compute    = FLOPs / 989e12           (dense bf16 tensor cores)
  memory     = HBM bytes / 3.35e12      (every eager op's operands and
               output, the units' charges from shapes: an UPPER estimate,
               ``utils/cost.py`` — see the analytic floor column)
  collective = collective bytes / 50e9  (one 400 Gb/s NDR port a card)

The records are ``launch/dryrun.py``'s, under ``artifacts/dryrun_torch/``:
counts of the program, not measurements of a card.

Analytic memory floor (what a perfect program must still move), the
reference's arithmetic as it is:
  train:   microbatches x 2 passes over params (4B f32 master) + optimizer
           pass (28B/param: read p,g,m,v + write p,m,v) + layer-boundary
           activations (2 x L x B x S x D x 2B)          [all / chips]
  prefill: quantized weight bytes + 2 x L x B x S x D x 2B
  decode:  quantized weight bytes + live KV-cache bytes (the paper's §2.1
           claim IS this term: latency tracks weight bits)
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import QuantConfig
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import HBM_BW

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
SERVE_BITS = QuantConfig(bits=4, dtype="float", block_size=64)


def _quantized_weight_bytes(cfg) -> float:
    """Stored bytes of the 4-bit-quantized serving weights (packing-aware)."""
    from repro_torch.core.packing import stored_bits_per_param

    n = cfg.param_count()
    n_emb = cfg.vocab_size * cfg.d_model  # embeddings stay 16-bit
    q = max(n - 2 * n_emb, 0)
    bits = stored_bits_per_param(SERVE_BITS.bits) + 16 / SERVE_BITS.block_size
    return q * bits / 8 + (n - q) * 2


def _kv_cache_bytes(cfg, shape) -> float:
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    for mixer, _ in cfg.layer_schedule():
        if mixer.startswith("attn"):
            w = cfg.sliding_window if mixer in ("attn_local",) or (
                mixer == "attn" and cfg.sliding_window) else 0
            eff = min(S, w) if w else S
            total += 2 * B * eff * cfg.n_kv_heads * cfg.head_dim * 2
        elif mixer == "ssm":
            total += B * (cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
                          + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) * 2)
    return total


def analytic_memory_floor(cfg, shape, kind, chips, microbatches=8) -> float:
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers
    act = 2 * L * B * S * D * 2  # layer-boundary activations, bf16, fwd+bwd-ish
    if kind == "train":
        n = cfg.param_count()
        weights = microbatches * 2 * 4 * n  # fwd+bwd reads of f32 master
        optimizer = 28 * n
        return (weights + optimizer + act) / chips
    if kind == "prefill":
        return (_quantized_weight_bytes(cfg) + act / 2) / chips
    # decode: one token -> weights + live cache
    wb = _quantized_weight_bytes(cfg)
    if cfg.n_experts:  # only active experts' weights stream per token
        wb *= max(cfg.active_param_count() / cfg.param_count(), 0.1)
    return (wb + _kv_cache_bytes(cfg, shape) + 0.0) / chips


def load_records(mesh: str | None = None):
    recs = []
    for p in sorted(ART.glob("*.json")):
        r = json.loads(p.read_text())
        if mesh and r["mesh"] != mesh:
            continue
        recs.append(r)
    return recs


def table(mesh="pod16x16", log=print, markdown=False):
    recs = load_records(mesh)
    rows = []
    header = (f"{'arch':24s} {'shape':12s} {'C ms':>9} {'M ms':>9} {'N ms':>9} "
              f"{'floor ms':>9} {'bneck':>7} {'useful':>7} {'MFU':>6} {'GB/dev':>7}")
    log(header)
    log("-" * len(header))
    for r in recs:
        if r["status"] != "ok":
            rows.append((f"roofline/{r['arch']}/{r['shape']}", 0.0,
                         f"SKIP:{r['reason'][:40]}"))
            continue
        cfg = get_arch(r["arch"])
        shape = SHAPES[r["shape"]]
        rl = r["roofline"]
        floor = analytic_memory_floor(cfg, shape, r["kind"], r["devices"]) / HBM_BW * 1e3
        gb = r["memory"]["peak_estimate"] / 1e9
        log(f"{r['arch']:24s} {r['shape']:12s} {rl['compute_ms']:9.2f} "
            f"{rl['memory_ms']:9.2f} {rl['collective_ms']:9.2f} {floor:9.2f} "
            f"{rl['bottleneck'][:7]:>7} {rl['useful_flops_ratio']:7.2f} "
            f"{rl['roofline_mfu']:6.3f} {gb:7.2f}")
        rows.append((
            f"roofline/{r['arch']}/{r['shape']}/{mesh}", 0.0,
            f"C={rl['compute_ms']:.2f}ms;M={rl['memory_ms']:.2f}ms;"
            f"N={rl['collective_ms']:.2f}ms;floor={floor:.2f}ms;"
            f"bneck={rl['bottleneck']};mfu={rl['roofline_mfu']:.3f}",
        ))
    return rows


def markdown_table(mesh="pod16x16"):
    recs = load_records(mesh)
    out = ["| arch | shape | kind | compute ms | memory ms | collective ms | "
           "analytic floor ms | bottleneck | useful FLOPs | peak GB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | skip | - | - | - | - | "
                       f"{r['reason'][:60]} | - | - |")
            continue
        cfg = get_arch(r["arch"])
        shape = SHAPES[r["shape"]]
        rl = r["roofline"]
        floor = analytic_memory_floor(cfg, shape, r["kind"], r["devices"]) / HBM_BW * 1e3
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{rl['compute_ms']:.2f} | {rl['memory_ms']:.2f} | "
            f"{rl['collective_ms']:.2f} | {floor:.2f} | {rl['bottleneck']} | "
            f"{rl['useful_flops_ratio']:.2f} | "
            f"{r['memory']['peak_estimate']/1e9:.2f} |")
    return "\n".join(out)


def run(log=print):
    rows = []
    for mesh in ("pod16x16", "pod2x16x16"):
        if any(True for _ in ART.glob(f"*__{mesh}.json")):
            log(f"\n== roofline ({mesh}) ==")
            rows += table(mesh, log=log)
    return rows, None
