#!/usr/bin/env python3
"""The KV dequant (``csrc/kv_dequant.cu``) in two store layouts, beside
another tree's kernel, at Qwen2-7B's decode caches.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/kv_dequant_layouts.py
    python3 scripts/kv_dequant_layouts.py --csrc OTHER/src/repro_torch/csrc

Two workloads, each layer its own random kv4 cache (4-bit float, blocks of
64, 512 features a slot): a decode step's caches (28 layers, batch 4, 288
slots) and a 40,960-slot cache at batch 1 (28 layers), the first
power-of-two length the fused attention does not take at Qwen2-7B's heads.
Kernels, each building its library from source with the port's nvcc flags:

* ``this``: the checkout's kernel, a warp's 128 words a round, lane l
  taking words l + 32 i, so each warp store covers 512 consecutive bytes;
* ``lane_words``: the same source with lane l taking words 4 l + i (its 4
  words' 64 bytes of bf16 stored by one lane, the warp's stores 64 bytes
  apart), a text substitution;
* ``other`` (with ``--csrc``): another tree's kv_dequant.cu; an entry that
  takes one leaf (``total_words``, the first design's) is launched twice a
  layer, for K and for V.

Each result is checked bit for bit against ``dequant_rows_ref``, then timed
as device time: a workload's launches captured in one CUDA graph, the
median of 20 replays by CUDA events, in turns (this, others, reversed).
Prints one JSON object a workload with the bytes bound (packed leaves read
once, bf16 K and V written once, at 3.35 TB/s), then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kv_dequant_layouts"
LAYERS, FEAT = 28, 512
WORKLOADS = {"step_caches": (4, 288), "long_40960": (1, 40960)}
LANE_WORDS = ("span * SPAN + lane + 32u * i", "span * SPAN + lane * WPL + i")


def build(text: str, tag: str) -> ctypes.CDLL:
    """A kv_dequant.cu source text compiled as the port compiles it."""
    from repro_torch.kernels import _build

    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / f"{tag}-{digest}.so"
    if not lib_path.is_file():
        src = OUT / f"{tag}-{digest}.cu"
        src.write_text(text)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.one_leaf = "long long total_words" in text
    if lib.one_leaf:
        lib.kv_dequant.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    else:
        lib.kv_dequant.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong]
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.kv_dequant.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="another tree's src/repro_torch/csrc")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kv_dequant_layouts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import kv_dequant as kvd

    text = (ROOT / "src" / "repro_torch" / "csrc" / "kv_dequant.cu").read_text()
    if LANE_WORDS[0] not in text:
        raise SystemExit("kv_dequant_layouts: the kernel's word index changed; "
                         "update LANE_WORDS")
    libs = {"this": build(text, "this"),
            "lane_words": build(text.replace(*LANE_WORDS), "lane_words")}
    if args.csrc:
        libs["other"] = build((args.csrc / "kv_dequant.cu").read_text(), "other")
    dev = torch.device("cuda")
    spec = kvd.KVQuantSpec(bits=4, block_size=64, dtype_name="float")
    bs, n_blocks, n_words = kvd.kv_layout(spec, FEAT)
    codebook = kvd.kv_codebook(spec, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def run(lib, cache):
        rows = cache["k_packed"].numel() // n_words
        outs = [torch.empty((rows, FEAT), dtype=torch.bfloat16, device=dev) for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream
        leaves = [(cache["k_packed"], cache["k_scales"]), (cache["v_packed"], cache["v_scales"])]
        if lib.one_leaf:
            for (p, s), o in zip(leaves, outs):
                cs.require(lib.kv_dequant(p.data_ptr(), s.data_ptr(), codebook.data_ptr(),
                                          o.data_ptr(), rows * n_words, n_words, n_blocks,
                                          spec.bits, bs, stream) == 0, "kv_dequant launch")
        else:
            ptrs = [x for (p, s), o in zip(leaves, outs)
                    for x in (p.data_ptr(), s.data_ptr(), o.data_ptr())]
            cs.require(lib.kv_dequant(*ptrs, codebook.data_ptr(), None, 0, rows, n_words,
                                      n_blocks, spec.bits, bs, stream) == 0, "kv_dequant launch")
        return outs

    order = list(libs) + list(reversed(list(libs)))
    for name, (B, S) in WORKLOADS.items():
        layers = cs._kv_layers(torch, dev, g, spec, B, S, FEAT, LAYERS)
        c0 = layers[0]
        for lib in libs.values():
            k, v = run(lib, c0)
            torch.cuda.synchronize()
            cs.require(all(torch.equal(a.view(torch.int16), kvd.dequant_rows_ref(
                c0[f"{x}_packed"], c0[f"{x}_scales"], spec, FEAT).reshape(a.shape)
                .view(torch.int16)) for a, x in ((k, "k"), (v, "v"))),
                f"{name}: a kernel is not bit-exact")
        times = {k: [] for k in libs}
        for k in order:
            times[k].append(cs._time_ms(torch, lambda lib=libs[k]: [run(lib, c) for c in layers],
                                        20))
        nbytes = LAYERS * (sum(t.numel() * t.element_size() for t in c0.values())
                           + 2 * B * S * FEAT * 2)
        print(json.dumps({name: {"batch": B, "slots": S, "layers": LAYERS, "ms": times,
                                 "bound_ms": cs._bound(nbytes, 0.0)[0], "bytes": nbytes}}),
              flush=True)
        del layers
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
