"""The port's example drivers (``repro_torch.examples``), each ``main`` run
on the CPU at small sizes, beside what the reference's drivers print.

The reference's drivers are scripts without a ``main`` and train at full
size; the port's take the sizes as flags whose defaults are the
reference's, so these runs shrink them.
"""

from __future__ import annotations

import math

import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.examples import quickstart, scaling_laws, serve_quantized, train_tiny_lm

torch.set_num_threads(2)

SMALL = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq-len", "16"]


def test_quickstart(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "fused 4-bit dequant-matmul kernel vs dense" in text
    rows = out["rows"]
    assert len(rows) == 8
    # more bits and smaller blocks quantize better (the paper's table)
    assert rows["int8-b64"][1] < rows["float4-b64"][1] < rows["int3-b64"][1]
    assert rows["float4-b64"][0] == pytest.approx(4.25)
    assert out["fused_rel_err"] == pytest.approx(rows["float4-b64"][2], rel=0.05)


def test_serve_quantized(capsys):
    out = serve_quantized.main(SMALL + ["--arch", "tiny-160k", "--max-new", "4"])
    assert list(out) == [label for label, _ in serve_quantized.CONFIGS]
    assert all(math.isfinite(r["ppl"]) and r["tokens_per_s"] > 0 for r in out.values())
    base = out["fp16 baseline"]["model_bytes"]
    assert all(r["model_bytes"] < base for label, r in out.items() if label != "fp16 baseline")
    assert "sample continuation" in capsys.readouterr().out


def test_train_tiny_lm_resumes_with_grad_compression(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    out = train_tiny_lm.main(SMALL[:2] + ["--arch", "tiny-160k", "--steps", "4",
                                          "--resume-at", "2", "--batch", "2", "--seq-len",
                                          "16", "--ckpt-every", "1", "--ckpt-dir", str(ckpt)])
    assert len(out["phase1"]) == 2 and len(out["phase2"]) == 2
    assert int(out["state"].opt.step) == 4 and out["state"].err is not None
    assert "[resume] step 2" in capsys.readouterr().out
    assert CheckpointManager(ckpt).all_steps()[-1] == 4


def test_scaling_laws(capsys):
    res = scaling_laws.main(SMALL + ["--sizes", "tiny-160k"])
    assert res["optimal_precision"] in (3, 4, 8, 16)
    assert "bit-level optimal precision" in capsys.readouterr().out
