"""The port's kernel microbench (``paper/kernel_bench.py``) against the JAX
package's (``benchmarks/kernel_bench.py``), on the CPU.

Inputs come from numpy seeds and go through both packages.  The bars:
  * each of the bench's four weights (int3, int4, float4, int8 at block 64)
    encoded by both ``_quantize_matrix``: codes, packed words and scale bits
    equal bit for bit; ``linear`` in "fused" and "dequant_einsum" mode with
    f32 x within 2e-5 relative of the reference's (f32 summation order,
    tests/test_qmatmul_parity.py);
  * ``kernel_bench.run(gate=False)`` on ``device="cpu"``: the reference's
    row names and JSON keys, plus the smoke's own row and key;
  * ``paper.run --only kernel`` trains nothing;
  * the f32 GEMV's launcher (``qmatmul_gemv_simt``) hands its kernel the
    rows as stored at 3, 5 and 6 bits where K is not a multiple of
    lcm(cpw, B): the tensors themselves, no padded copy (its kernel is held
    to its plain version on the card, tests/test_torch_on_card.py).
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # benchmarks/ is a repo-root package

from benchmarks import common as rcommon  # noqa: E402
from benchmarks import kernel_bench as rkb  # noqa: E402
from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.core import packing as rpacking  # noqa: E402
from repro.models.layers import linear as r_linear  # noqa: E402
from repro.models.quantize import _quantize_matrix as r_quantize_matrix  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import qmatmul as tqm  # noqa: E402
from repro_torch.models.layers import linear  # noqa: E402
from repro_torch.models.quantize import _quantize_matrix  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402
from repro_torch.paper import kernel_bench as tkb  # noqa: E402
from repro_torch.paper import run as trun  # noqa: E402

REL_TOL = 2e-5   # f32 summation order (tests/test_qmatmul_parity.py)

torch.set_num_threads(2)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


def test_bench_shape_and_weights_are_the_references():
    assert (tkb.M, tkb.K, tkb.N) == (rkb.M, rkb.K, rkb.N) == (8, 2048, 2048)
    assert (tkb.FUSED_GATE_X, tkb.GATE_ATTEMPTS) == (rkb.FUSED_GATE_X, rkb.GATE_ATTEMPTS)
    assert tkb.TAGS == ((3, "int"), (4, "int"), (4, "float"), (8, "int"))


@pytest.mark.parametrize("bits,dtype", [(3, "int"), (4, "int"), (4, "float"), (8, "int")])
def test_bench_weights_and_both_modes_match_reference(bits, dtype):
    """One of the bench's weights at a small size (K, N = 256, 128; x of 8
    f32 rows): the encode bit for bit, then y in both modes."""
    rs = np.random.RandomState(bits * 10 + len(dtype))
    w = (rs.randn(256, 128) * 0.02).astype(np.float32)
    x = rs.randn(8, 256).astype(np.float32)
    rqt = r_quantize_matrix(jnp.asarray(w), RQuantConfig(bits=bits, dtype=dtype, block_size=64))
    tqt = _quantize_matrix(_t(w), QuantConfig(bits=bits, dtype=dtype, block_size=64))
    assert tqt.quant_shape == tuple(rqt.quant_shape) == (128, 256)
    assert np.array_equal(tqt.packed.numpy().view(np.uint32), np.asarray(rqt.packed))
    assert np.array_equal(tqt.scales.view(torch.int16).numpy(),
                          np.asarray(rqt.scales).view(np.int16))
    assert np.array_equal(packing.unpack(tqt.packed, bits, 256).numpy(),
                          np.asarray(rpacking.unpack(rqt.packed, bits, 256)))
    for mode in ("fused", "dequant_einsum"):
        y_r = jax.jit(lambda x, m=mode: r_linear(x, rqt, mode=m))(jnp.asarray(x))
        y_t = linear(_t(x), tqt, mode=mode)
        assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (8, 128)
        assert _rel(y_t.numpy(), y_r) < REL_TOL, (mode, _rel(y_t.numpy(), y_r))


def _reference_names_and_keys(tmp_path, monkeypatch):
    """The reference bench's rows and JSON keys, its timings stubbed out (the
    names and keys do not depend on them)."""
    monkeypatch.setattr(rcommon, "ART", tmp_path / "reference")
    monkeypatch.setattr(rkb.common, "timed_robust", lambda fn, *a, **k: 1.0)
    rows, out = rkb.run(log=lambda *a: None, gate=False)
    return [r[0] for r in rows], out


def test_kernel_bench_run_on_cpu_gives_the_reference_rows_and_keys(tmp_path, monkeypatch):
    r_names, r_out = _reference_names_and_keys(tmp_path, monkeypatch)
    monkeypatch.setattr(tcommon, "ART", tmp_path)
    rows, out = tkb.run(log=lambda *a: None, gate=False, smoke=True, device="cpu")
    names = [r[0] for r in rows]
    assert names == r_names + ["kernel/cuda_kernel_smoke"]
    assert set(out) == set(r_out) | {"kernel_smoke"}
    assert out["shape"] == r_out["shape"] and out["gate_x"] == r_out["gate_x"]
    assert set(out["fused"]) == set(r_out["fused"])
    for tag, entry in out["fused"].items():
        assert set(entry) == set(r_out["fused"][tag])
        assert entry["weight_bytes"] == r_out["fused"][tag]["weight_bytes"]
        assert entry["us_fused"] > 0 and entry["us_dequant_einsum"] > 0
    assert out["kernel_smoke"]["ok"] and out["kernel_smoke"]["rel_err"] < tkb.SMOKE_REL_TOL
    meta = out["meta"]
    assert meta["platform"] == "cpu" and meta["torch_version"] == torch.__version__
    saved = json.loads((tmp_path / "bench_torch" / "kernel_bench.json").read_text())
    assert [r[0] for r in saved["rows"]] == names


def test_paper_run_kernel_suite_trains_nothing(tmp_path, monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel suite trained the ladder")

    monkeypatch.setattr(tcommon, "trained_family", refuse)
    monkeypatch.setattr(tcommon, "ART", tmp_path)
    monkeypatch.setattr(tcommon, "timed_robust", lambda fn, *a, **k: 1.0)
    trun.main(["--only", "kernel", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    tags = [f"{dt}{b}" for b, dt in tkb.TAGS]
    assert [line.split(",")[0] for line in out[1:]] == ["kernel/dense_f32"] + [
        f"kernel/{k}_{t}" for t in tags for k in ("dequant_einsum", "fused")]


def test_timed_robust_times_each_call():
    """One warm-up call, then one sample a repeat; the estimate is a time."""
    calls = []

    def fn(v):
        calls.append(v)
        return torch.zeros(1)

    h = tcommon.sample_times(fn, 7, repeats=5)
    assert h.count == 5 and calls == [7] * 6
    us = tcommon.timed_robust(fn, 7, repeats=4)
    assert 0 < us < 1e6 and us <= tcommon.timed(fn, 7, repeats=4) * 10


class _FakeLib:
    """Stands in for the built qmatmul library: records each launch."""

    def __init__(self):
        self.calls = []

    def qmatmul_gemv(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("bits,block", [(3, 64), (5, 64), (6, 64), (5, 10), (6, 6)])
def test_gemv_simt_launcher_passes_rows_as_stored(bits, block, monkeypatch):
    """K is a whole number of scale blocks but not of lcm(cpw, B): the
    launcher hands the kernel x, the words and the scales as they are
    (ceil(K / cpw) words a row), no padded copy, and counts one launch."""
    cpw = 32 // bits
    K = next(k for k in range(block, 40 * block, block) if k % np.lcm(cpw, block))
    N = 70
    lib = _FakeLib()
    monkeypatch.setattr(tqm, "_lib", lambda: lib)
    monkeypatch.setattr(tqm, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    rs = np.random.RandomState(bits + block)
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.tensor(rs.randn(4, K), dtype=torch.float32).to(xdt)
        packed = torch.tensor(rs.randint(-2**31, 2**31 - 1, (N, -(-K // cpw))), dtype=torch.int32)
        scales = torch.ones((N, K // block), dtype=torch.bfloat16)
        cb = torch.linspace(-1, 1, 2 ** bits)
        before = tqm.qmatmul_gemv_simt.launches
        y = tqm.qmatmul_gemv_simt(x, packed, scales, cb, bits=bits, block_size=block)
        assert tqm.qmatmul_gemv_simt.launches == before + 1
        assert y.dtype == xdt and tuple(y.shape) == (4, N)
        xp, pp, sp, cp, yp, M, N_, K_, n_words, b, B, is_bf16, _ = lib.calls[-1]
        assert (xp, pp, sp, cp, yp) == (x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                                        cb.data_ptr(), y.data_ptr())
        assert (M, N_, K_, n_words, b, B) == (4, N, K, -(-K // cpw), bits, block)
        assert is_bf16 == int(xdt == torch.bfloat16)
