"""Assemble the §Dry-run and §Roofline tables from the dry-run's records
(baseline = artifacts/dryrun_torch_baseline, optimized =
artifacts/dryrun_torch) — port of ``benchmarks/make_experiments.py``.  The
§Perf prose is kept by hand; this script prints the per-cell before/after
used there.  The numbers are ``launch/dryrun.py``'s counts at the H100's
rates, not measurements of a card; the columns keep the reference's names
("compile s": the seconds to run and cost a cell, "HLO GFLOP": the counted
FLOPs a rank).

    PYTHONPATH=src python -m repro_torch.paper.make_experiments > artifacts/experiments_tables_torch.md
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import HBM_BW

ROOT = Path(__file__).resolve().parents[3] / "artifacts"
OPTIMIZED, BASELINE = "dryrun_torch", "dryrun_torch_baseline"


def load(d, mesh):
    out = {}
    for p in sorted((ROOT / d).glob(f"*__{mesh}.json")):
        r = json.loads(p.read_text())
        out[(r["arch"], r["shape"])] = r
    return out


def dryrun_section():
    print("## §Dry-run\n")
    for mesh, title in (("pod16x16", "one mesh (16x16 = 256 H100s)"),
                        ("pod2x16x16", "two meshes (2x16x16 = 512 H100s)")):
        recs = load(OPTIMIZED, mesh)
        base = load(BASELINE, mesh)
        use = recs if recs else base
        ok = sum(1 for r in use.values() if r["status"] == "ok")
        sk = sum(1 for r in use.values() if r["status"] == "skipped")
        print(f"### {title}: {ok} costed, {sk} documented skips\n")
        print("| arch | shape | kind | compile s | peak GB/dev | args GB/dev |"
              " HLO GFLOP/dev | coll GB/dev |")
        print("|---|---|---|---|---|---|---|---|")
        for (a, s), r in sorted(use.items()):
            if r["status"] != "ok":
                print(f"| {a} | {s} | skip | - | - | - | - | {r['reason'][:45]} |")
                continue
            m = r["memory"]
            print(f"| {a} | {s} | {r['kind']} | {r['compile_s']:.0f} | "
                  f"{m['peak_estimate']/1e9:.2f} | {m['argument_bytes']/1e9:.2f} | "
                  f"{r['hlo_cost']['flops_per_device']/1e9:.1f} | "
                  f"{r['hlo_cost']['collective_bytes_per_device']/1e9:.3f} |")
        print()


def roofline_section():
    from repro_torch.paper.roofline import analytic_memory_floor

    print("## §Roofline (one mesh of 256 H100s, optimized build)\n")
    recs = load(OPTIMIZED, "pod16x16")
    print("| arch | shape | compute ms | memory ms | collective ms | floor ms"
          " | bottleneck | MODEL/HLO FLOPs | roofline-MFU |")
    print("|---|---|---|---|---|---|---|---|---|")
    for (a, s), r in sorted(recs.items()):
        if r["status"] != "ok":
            continue
        cfg = get_arch(a)
        shape = SHAPES[s]
        rl = r["roofline"]
        floor = analytic_memory_floor(cfg, shape, r["kind"], r["devices"]) / HBM_BW * 1e3
        print(f"| {a} | {s} | {rl['compute_ms']:.2f} | {rl['memory_ms']:.2f} |"
              f" {rl['collective_ms']:.2f} | {floor:.2f} | {rl['bottleneck']} |"
              f" {rl['useful_flops_ratio']:.2f} | {rl['roofline_mfu']:.3f} |")
    print()


def perf_deltas():
    print("## §Perf raw before/after (baseline -> optimized)\n")
    print("| arch | shape | C ms b->o | M ms b->o | N ms b->o | peak GB b->o |")
    print("|---|---|---|---|---|---|")
    base = load(BASELINE, "pod16x16")
    opt = load(OPTIMIZED, "pod16x16")
    for key in sorted(set(base) & set(opt)):
        b, o = base[key], opt[key]
        if b["status"] != "ok" or o["status"] != "ok":
            continue
        rb, ro = b["roofline"], o["roofline"]
        print(f"| {key[0]} | {key[1]} | "
              f"{rb['compute_ms']:.1f}->{ro['compute_ms']:.1f} | "
              f"{rb['memory_ms']:.1f}->{ro['memory_ms']:.1f} | "
              f"{rb['collective_ms']:.1f}->{ro['collective_ms']:.1f} | "
              f"{b['memory']['peak_estimate']/1e9:.2f}->"
              f"{o['memory']['peak_estimate']/1e9:.2f} |")
    print()


if __name__ == "__main__":
    dryrun_section()
    roofline_section()
    perf_deltas()
