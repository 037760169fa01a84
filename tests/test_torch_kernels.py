"""The port's kernel layer (repro_torch.kernels) against the JAX package's.

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held against the reference's oracles here:
  * fused dequant-GEMM (B1): f32 activations within 2e-5 relative of
    ``repro.kernels.ref.qmatmul_ref`` (f32 summation order, the reference's
    REL_TOL); bf16 activations within one bf16 ulp at max|y| (2^-7 * max|y|)
    of the reference's fused jnp path, over test_qmatmul_parity.py's sweep;
  * KV dequant (B2) and ``encode_rows``: bit-exact.
One interpret-mode case of each Pallas kernel (marked ``kernel``) is held
against the plain version, as the reference's own tests run them.  Cases
marked ``cuda`` hold each CUDA kernel against its plain version and skip
without a GPU.  The last tests check the default device and that the port
never imports jax or ``repro``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import kv_dequant as rkv  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.ref import QMatmulOperand as RQMatmulOperand  # noqa: E402
from repro.kernels.ref import qmatmul_ref as r_qmatmul_ref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import kv_dequant as tkv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import qmatmul as tqm  # noqa: E402
from repro_torch.kernels.ref import QMatmulOperand, qmatmul_ref  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 2e-5          # f32 summation order (tests/test_qmatmul_parity.py)
BF16_REL_TOL = 2.0 ** -7

# (bits, dtype, block, M, K, N) — test_qmatmul_parity.py's SWEEP, plus dynamic
SWEEP = [
    (3, "int", 64, 8, 2048, 96),
    (3, "float", 16, 1, 200, 40),
    (4, "float", 64, 8, 256, 128),
    (4, "int", 32, 5, 100, 70),
    (4, "dynamic", 64, 9, 192, 40),
    (5, "float", 64, 8, 192, 64),
    (5, "int", 16, 3, 50, 33),
    (6, "float", 32, 8, 160, 96),
    (6, "int", 64, 2, 320, 48),
    (8, "int", 64, 8, 256, 128),
    (8, "float", 32, 4, 128, 64),
    (8, "dynamic", 64, 20, 128, 48),
]


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        return b.dtype == a.dtype and torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def _rel_err(y, y_ref) -> float:
    y = np.asarray(y, np.float32)
    y_ref = np.asarray(y_ref, np.float32)
    return float(np.abs(y - y_ref).max()) / (float(np.abs(y_ref).max()) + 1e-9)


def _operands(bits, dtype, block, M, K, N, seed):
    """The same weight and activations for both packages: the reference's
    operand, its oracle on f32 x and its fused jnp path on bf16 x (one
    compilation), and the port's own operand, which must be identical."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(K, N) * 0.05).astype(np.float32)
    x = rs.randn(M, K).astype(np.float32)
    Kb = -(-K // block) * block
    xp = np.pad(x, ((0, 0), (0, Kb - K)))

    def ref(a, xf, xb):
        op = rops.prepare_operand(a, bits=bits, dtype=dtype, block_size=block)
        return (op.packed, op.scales, op.codebook, r_qmatmul_ref(xf, op),
                rops.qmatmul_fused_jnp(xb, op))

    packed, scales, cb, y, yb = jax.jit(ref)(jnp.asarray(w), jnp.asarray(xp),
                                             jnp.asarray(xp, jnp.bfloat16))
    r_op = RQMatmulOperand(packed=packed, scales=scales, codebook=cb, bits=bits,
                           block_size=block, k_dim=Kb, dtype_name=dtype)
    t_op = tops.prepare_operand(_t(w), bits=bits, dtype=dtype, block_size=block)
    return x, xp, r_op, t_op, np.asarray(y), np.asarray(yb.astype(jnp.float32))


def _carried(r_op) -> QMatmulOperand:
    return QMatmulOperand(packed=_t(r_op.packed), scales=_t(r_op.scales),
                          codebook=_t(r_op.codebook), bits=r_op.bits,
                          block_size=r_op.block_size, k_dim=r_op.k_dim,
                          dtype_name=r_op.dtype_name)


@pytest.mark.parametrize("bits,dtype,block,M,K,N", SWEEP)
def test_qmatmul_plain_matches_reference(bits, dtype, block, M, K, N):
    x, xp, r_op, t_op, y_ref, yb_ref = _operands(bits, dtype, block, M, K, N,
                                                 seed=bits * 101 + K)
    assert _bits_equal(t_op.packed, _t(r_op.packed))
    assert _bits_equal(t_op.scales, _t(r_op.scales))
    assert t_op.k_dim == r_op.k_dim
    # f32: the port's fused path (padding + plain kernel version) and oracle
    assert _rel_err(tops.fused_matmul(_t(x), t_op).numpy(), y_ref) < REL_TOL
    assert _rel_err(qmatmul_ref(_t(xp), t_op).numpy(), y_ref) < REL_TOL
    # bf16: one bf16 ulp at max|y| of the reference's fused jnp path
    yb = tops.fused_matmul(_t(jnp.asarray(xp, jnp.bfloat16))[:, :K], t_op)
    assert yb.dtype == torch.bfloat16
    assert np.abs(yb.float().numpy() - yb_ref).max() <= BF16_REL_TOL * np.abs(yb_ref).max()


def test_qmatmul_leading_dims_and_padding():
    """[B, S, K] activations narrower than the stored K, as prefill gives."""
    x, _, _, t_op, y_ref, _ = _operands(5, "float", 32, 6, 90, 33, seed=7)
    y = tops.qmatmul(_t(x.reshape(2, 3, 90)), t_op)
    assert tuple(y.shape) == (2, 3, 33)
    assert _rel_err(y.reshape(6, 33).numpy(), y_ref) < REL_TOL
    # only K is padded (to lcm(cpw, block) = 96); the kernels mask rows and columns
    for M in (6, 9):
        xp, packed, scales = tops.pad_for_kernel(torch.zeros(M, 90), t_op)
        assert tuple(xp.shape) == (M, 96) and packed.shape[1] * 6 == 96 == scales.shape[1] * 32
        assert packed.shape[0] == scales.shape[0] == 33


@pytest.mark.kernel
def test_qmatmul_plain_matches_pallas_interpret():
    x, _, r_op, _, _, _ = _operands(4, "float", 32, 4, 128, 32, seed=3)
    y_pallas = np.asarray(rops.qmatmul(jnp.asarray(x), r_op, use_kernel=True, interpret=True))
    assert _rel_err(tops.qmatmul(_t(x), _carried(r_op)).numpy(), y_pallas) < REL_TOL


KV_CASES = [(bits, dtype) for bits in (4, 8) for dtype in ("int", "float", "dynamic")]


@pytest.mark.parametrize("bits,dtype", KV_CASES)
@pytest.mark.parametrize("feat,block", [(512, 64), (48, 32)])
def test_kv_encode_and_dequant_bit_exact(bits, dtype, feat, block):
    rs = np.random.RandomState(bits * 7 + feat)
    x = jnp.asarray(rs.randn(2, 5, feat) * rs.lognormal(0, 1, (2, 5, 1)), jnp.bfloat16)
    r_spec = rkv.KVQuantSpec(bits=bits, block_size=block, dtype_name=dtype)
    t_spec = tkv.KVQuantSpec(bits=bits, block_size=block, dtype_name=dtype)
    assert tkv.kv_layout(t_spec, feat) == rkv.kv_layout(r_spec, feat)
    assert tkv.kv_stored_bytes_per_token(t_spec, feat) == \
        rkv.kv_stored_bytes_per_token(r_spec, feat)

    def ref(x):
        p, s = rkv.encode_rows(x, r_spec)
        return p, s, rkv.dequant_rows_ref(p, s, r_spec, feat)

    rp, rs_, rout = jax.jit(ref)(x)
    tp, ts = tkv.encode_rows(_t(x), t_spec)
    assert _bits_equal(tp, _t(rp)) and _bits_equal(ts, _t(rs_))
    out = tkv.dequant_rows(tp, ts, t_spec, feat)
    assert _bits_equal(out, _t(rout))


@pytest.mark.kernel
def test_kv_dequant_plain_matches_pallas_interpret():
    spec = rkv.KVQuantSpec(bits=4, block_size=64, dtype_name="int")
    x = jnp.asarray(np.random.RandomState(0).randn(6, 128), jnp.bfloat16)
    p, s = rkv.encode_rows(x, spec)
    out = rkv.dequant_rows_pallas(p, s, spec, 128, interpret=True)
    t_spec = tkv.KVQuantSpec(bits=4, block_size=64, dtype_name="int")
    assert _bits_equal(tkv.dequant_rows(_t(p), _t(s), t_spec, 128), _t(out))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built with nvcc and run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,block,M,K,N", SWEEP[:6] + [(4, "float", 64, 64, 512, 256)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_qmatmul_cuda_kernel_matches_plain(bits, dtype, block, M, K, N, xdt):
    _need_cuda()
    dev = torch.device("cuda")
    rs = np.random.RandomState(bits + K)
    op = tops.prepare_operand(torch.tensor(rs.randn(K, N) * 0.05, dtype=torch.float32,
                                           device=dev), bits=bits, dtype=dtype, block_size=block)
    x = torch.tensor(rs.randn(M, K), device=dev).to(getattr(torch, xdt))
    xp, packed, scales = tops.pad_for_kernel(x, op)
    kw = dict(bits=bits, block_size=block)
    y_k = tqm.qmatmul_cuda(xp, packed, scales, op.codebook, **kw).float()
    y_p = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw).float()
    tol = (REL_TOL if xdt == "float32" else BF16_REL_TOL) * float(y_p.abs().max())
    assert float((y_k - y_p).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype", KV_CASES)
@pytest.mark.parametrize("feat,block", [(512, 64), (48, 6)])  # 6: words straddle blocks
def test_kv_dequant_cuda_kernel_bit_exact(bits, dtype, feat, block):
    _need_cuda()
    spec = tkv.KVQuantSpec(bits=bits, block_size=block, dtype_name=dtype)
    x = torch.randn(37, feat, device="cuda").to(torch.bfloat16)
    p, s = tkv.encode_rows(x, spec)
    assert _bits_equal(tkv.dequant_rows_cuda(p, s, spec, feat),
                       tkv.dequant_rows_ref(p, s, spec, feat))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is usable")
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params
    from repro_torch.serving import Engine

    cfg = get_arch("tiny-160k")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_params(params, QuantConfig(bits=4), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg, max_seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.params_from_reference({"w": np.zeros(2, np.float32)})


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_reference():
    """Statically (every import statement of the port and chip_smoke.py)
    and at run time: a fresh interpreter imports every module and runs
    chip_smoke, which without CUDA exits non-zero and prints no result."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    mods = []
    for f in files:
        bad = {m for m in _imports(f)
               if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")}
        assert not bad, (f, bad)
        if f.name != "chip_smoke.py":
            rel = f.relative_to(ROOT / "src").with_suffix("")
            mods.append(".".join(p for p in rel.parts if p != "__init__"))
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke, torch\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not leaked, leaked\n"
        "if not torch.cuda.is_available():\n"
        "    assert chip_smoke.main() != 0\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert '"ok"' not in res.stdout
