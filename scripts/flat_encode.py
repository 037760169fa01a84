#!/usr/bin/env python3
"""The flat encode (``csrc/quantize.cu``) on the paper sweep's flat items and
on Qwen2-7B's f32 contract, this checkout's kernel beside another tree's.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/flat_encode.py                        # this checkout's kernel
    python3 scripts/flat_encode.py --csrc OTHER/src/repro_torch/csrc

Trains the tiny ladder for ``--steps`` steps (2 by default: the suites'
shapes, not the models' quality), runs the sweep's three suites (fig2,
fig3 data types, fig3 block sizes) on the card, recording every flat-item
encode (``chip_smoke.flat_encodes``: the items whose columns are not whole
blocks, and ``ops.prepare_operand``), and times those launches through each
kernel's C entry (given the codebook, or, for the first design's entry, its
midpoints computed beforehand), so the time is the kernel's own: all
launches captured in one CUDA graph, the median of 10 replays by CUDA
events.  Then one Qwen2-7B encode's f32
contract (an item of each matrix shape, blocks of 64, weighted by its
count in the model).  `--csrc` builds quantize.cu from another tree (say a
parent commit unpacked with git archive under build/) with the port's nvcc
flags; the two kernels are timed in turns (this, other, other, this).
Prints one JSON object a measurement, the suites' seconds, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flat_encode"


def build(csrc: Path) -> ctypes.CDLL:
    """quantize.cu of `csrc`, compiled as the port compiles it; its
    ``takes_codebook`` is False for an entry that takes the midpoints
    (the first design's)."""
    from repro_torch.kernels import _build

    src = csrc / "quantize.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib_path = OUT / f"quantize-{digest}.so"
    if not lib_path.is_file():
        OUT.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.quantize_blocks.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.quantize_blocks.restype = ctypes.c_int
    lib.takes_codebook = "int n_codes" in src.read_text()
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="another tree's src/repro_torch/csrc")
    ap.add_argument("--steps", type=int, default=2, help="training steps a model")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flat_encode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.paper import common, fig2_bitlevel, fig3_blocksize, fig3_datatypes

    dev = torch.device("cuda")
    libs = {"this": build(ROOT / "src" / "repro_torch" / "csrc")}
    if args.csrc:
        libs["other"] = build(args.csrc)
    order = ["this", "other", "other", "this"] if args.csrc else ["this", "this"]

    def quiet(*_):
        pass

    family = common.trained_family(log=quiet, device=dev, steps=args.steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cs.flat_encodes() as flat:
        fig2_bitlevel.run(family, log=quiet)
        fig3_datatypes.run(family, log=quiet)
        fig3_blocksize.run(family, log=quiet)
        torch.cuda.synchronize()
    suites_s = time.perf_counter() - t0
    times = {k: [] for k in libs}
    for k in order:
        times[k].append(cs._time_ms(torch, cs.flat_encode_run(torch, flat, libs[k],
                                                              libs[k].takes_codebook), 10))
    print(json.dumps({"sweep_flat_items": {
        "launches": len(flat), "values": sum(xb.numel() for xb, _ in flat),
        "blocks": sorted({xb.shape[1] for xb, _ in flat}), "ms": times,
        "suites_s": suites_s}}), flush=True)
    del flat

    cfg = get_arch("qwen2-7b")
    cb = make_codebook("float", 4, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    total = {k: [0.0] * len(v) for k, v in times.items()}
    bound = 0.0
    for (rows, cols), n in cs._qwen_items(cfg).items():
        xb = torch.randn((rows * cols // 64, 64), generator=g, device=dev)
        per = {k: [] for k in libs}
        for k in order:
            per[k].append(cs._time_ms(torch, cs.flat_encode_run(torch, [(xb, cb)], libs[k],
                                                                libs[k].takes_codebook), 10))
        for k, v in per.items():
            total[k] = [a + n * b for a, b in zip(total[k], v)]
        bound += n * cs._bound(xb.numel() * 8 + xb.shape[0] * 4 + cb.numel() * 4, 0.0)[0]
        print(json.dumps({"qwen2_7b_item": f"{rows}x{cols}", "per_encode": n, "ms": per}),
              flush=True)
        del xb
        torch.cuda.empty_cache()
    print(json.dumps({"qwen2_7b_f32_contract": {"ms": total, "bound_ms": bound}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
