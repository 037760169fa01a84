"""The port's kernel layer (repro_torch.kernels) against the JAX package's.

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held against the reference's oracles here:
  * fused dequant-GEMM (B1): f32 activations within 2e-5 relative of
    ``repro.kernels.ref.qmatmul_ref`` (f32 summation order, the reference's
    REL_TOL); bf16 activations within one bf16 ulp at max|y| (2^-7 * max|y|)
    of the reference's fused jnp path, over test_qmatmul_parity.py's sweep;
  * KV dequant (B2) and ``encode_rows``: bit-exact;
  * blockwise encode (B3): codes and scale bits identical to the reference's
    Pallas kernel in interpret mode and to its ``quantize_blocks_ref``, over
    bits 3..8 x {int, float, dynamic, quantile} x B {16, 32, 33, 48, 64,
    128, 256, 1024}, on
    inputs that hold codebook values and exact midpoints.
One interpret-mode case of B1 and B2 (marked ``kernel``) is held against
the plain version, as the reference's own tests run them; B3's whole grid
runs in interpret mode, one compilation per bit width.  Cases
marked ``cuda`` hold each CUDA kernel against its plain version and skip
without a GPU; among them the tensor-core GEMV (``qmatmul_gemv_tc``) over
its row counts, column and K tails, widths, data types and blocks.  On the
CPU: ``qmatmul_plain`` against ``qmatmul_ref`` at 3, 5 and 6 bits (words
that do not hold whole groups of 4 codes), which operands ``gemv_route``
sends to it, that the routed widths are the kernel sources' cases, the f32
GEMM's K-split plan, and that the launchers refuse what their kernels do
not take.  The last tests check the default device and that
the port never imports jax or ``repro``.
"""

import ast
import functools
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import codebooks as rc  # noqa: E402
from repro.kernels import kv_dequant as rkv  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.ref import QMatmulOperand as RQMatmulOperand  # noqa: E402
from repro.kernels.ref import qmatmul_ref as r_qmatmul_ref  # noqa: E402
from repro.kernels.ref import quantize_blocks_ref as r_quantize_blocks_ref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import kv_dequant as tkv  # noqa: E402
from repro_torch.core.codebooks import make_codebook as t_make_codebook  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import qmatmul as tqm  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
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
    (7, "float", 64, 8, 256, 128),
    (7, "int", 32, 5, 100, 70),
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


@functools.lru_cache(maxsize=None)
def _low_bit_case(bits, block):
    """A weight with K and N tails (K = 200 pads to lcm(cpw, block), N = 70)
    and 5 rows of x, through the reference: its operand, qmatmul_ref on f32
    x and on x rounded to bf16, and its fused jnp path on bf16 x (one
    compilation a case)."""
    rs = np.random.RandomState(bits * 1009 + block)
    M, K, N = 5, 200, 70
    w = (rs.randn(K, N) * 0.05).astype(np.float32)
    x = rs.randn(M, K).astype(np.float32)

    def ref(a, xf, xb):
        op = rops.prepare_operand(a, bits=bits, dtype="float", block_size=block)
        xk = jnp.pad(xf, ((0, 0), (0, op.k_dim - K)))
        xbk = jnp.pad(xb, ((0, 0), (0, op.k_dim - K)))
        return (op.packed, op.scales, op.codebook, r_qmatmul_ref(xk, op),
                r_qmatmul_ref(xbk.astype(jnp.float32), op), rops.qmatmul_fused_jnp(xbk, op))

    packed, scales, cb, y, y_bx, yb = jax.jit(ref)(jnp.asarray(w), jnp.asarray(x),
                                                  jnp.asarray(x, jnp.bfloat16))
    return (w, x, packed, scales, np.asarray(y), np.asarray(y_bx),
            np.asarray(yb.astype(jnp.float32)))


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("bits", [3, 5, 6])
def test_qmatmul_plain_matches_reference_at_3_5_6_bits(bits, block, xdt):
    """The widths whose packed words do not hold whole groups of 4 codes
    (cpw 10, 6 and 5): the port's operand is the reference's bit for bit,
    and qmatmul_plain on it, in both layouts the kernels take (rows as
    stored, which kernels/ops.pad_for_kernel gives every kernel, and K
    padded to whole words, which the bf16 prefill GEMM's launcher pads to), is
    within 2e-5 of qmatmul_ref with f32 x, and
    within one bf16 ulp at max|y| of qmatmul_ref and of the fused jnp path
    with bf16 x."""
    w, x, packed, scales, y, y_bx, yb = _low_bit_case(bits, block)
    op = tops.prepare_operand(_t(w), bits=bits, dtype="float", block_size=block)
    assert _bits_equal(op.packed, _t(packed)) and _bits_equal(op.scales, _t(scales))
    xt = _t(x) if xdt == "float32" else _t(jnp.asarray(x, jnp.bfloat16))
    cpw = 32 // bits
    stored = tops.pad_for_kernel(xt, op)
    whole = tqm.pad_k(*stored, math.lcm(cpw, block, 8), bits=bits, block_size=block)
    assert stored[0].shape[1] == op.k_dim
    assert stored[1].shape[1] == -(-op.k_dim // cpw)
    assert whole[0].shape[1] == whole[1].shape[1] * cpw and whole[0].shape[1] % block == 0
    for xp, pk, sc in (stored, whole):
        out = tqm.qmatmul_plain(xp, pk, sc, op.codebook, bits=bits, block_size=block)
        assert out.dtype == xt.dtype and tuple(out.shape) == (5, 70)
        if xdt == "float32":
            assert _rel_err(out.numpy(), y) < REL_TOL
        else:
            for ref in (y_bx, yb):
                assert np.abs(out.float().numpy() - ref).max() <= \
                    BF16_REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_pad_k_adds_nothing_to_the_product(bits):
    """The launchers' K padding (kernels/qmatmul.pad_k): from rows as stored
    to K a multiple of whole words and blocks (lcm(cpw, B)) or of what the
    prefill GEMM (lcm(cpw, B, 8)) takes, the rows still ceil(K / cpw) words
    and whole scale blocks; the plain product on the padded operands within
    2e-5 of the stored ones', and no copy where K is a multiple already."""
    cpw = 32 // bits
    rs = np.random.RandomState(bits + 300)
    for block in (6, 10, 12, 16, 64):
        for K in (90, 200):
            op = tops.prepare_operand(torch.tensor(rs.randn(K, 33) * 0.05, dtype=torch.float32),
                                      bits=bits, dtype="float", block_size=block)
            stored = tops.pad_for_kernel(torch.tensor(rs.randn(5, K), dtype=torch.float32), op)
            kw = dict(bits=bits, block_size=block)
            y0 = tqm.qmatmul_plain(*stored, op.codebook, **kw).numpy()
            for unit in (math.lcm(cpw, block), math.lcm(cpw, block, 8)):
                xp, packed, scales = tqm.pad_k(*stored, unit, **kw)
                Kp = xp.shape[1]
                assert Kp % unit == 0 and Kp - unit < op.k_dim <= Kp
                assert packed.shape == (33, -(-Kp // cpw)) and scales.shape == (33, Kp // block)
                if Kp == op.k_dim:
                    assert packed.data_ptr() == op.packed.data_ptr()
                y1 = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw).numpy()
                assert _rel_err(y1, y0) < REL_TOL, (block, K, unit)


def test_qmatmul_leading_dims_and_padding():
    """[B, S, K] activations narrower than the stored K, as prefill gives."""
    x, _, _, t_op, y_ref, _ = _operands(5, "float", 32, 6, 90, 33, seed=7)
    y = tops.qmatmul(_t(x.reshape(2, 3, 90)), t_op)
    assert tuple(y.shape) == (2, 3, 33)
    assert _rel_err(y.reshape(6, 33).numpy(), y_ref) < REL_TOL
    # only x's K is padded (to the stored 96); the kernels mask rows and columns
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


# the paper sweep's blocks (32 to 1024; paper/fig3_blocksize.py) and 16, 48
# and an odd 33, which the CUDA kernel encodes with its one-warp body
ENCODE_BLOCKS = (16, 32, 33, 48, 64, 128, 256, 1024)


def _encode_input(cb: np.ndarray, block: int, seed: int) -> np.ndarray:
    """Blocks whose absmax is a power of two s and whose other values are
    codebook values and midpoints times s, so x / s hits them exactly; then
    random blocks of mixed scale and a partial last block."""
    rs = np.random.RandomState(seed)
    special = np.concatenate([cb, (cb[:-1] + cb[1:]) / np.float32(2.0)]).astype(np.float32)
    special = np.concatenate([special, -special])
    parts = []
    for i in range(0, special.size, block - 1):
        s = np.float32(2.0 ** rs.randint(-6, 3))
        blk = np.concatenate([[np.float32(1.0)], special[i: i + block - 1]]) * s
        parts.append(np.pad(blk, (0, block - blk.size)))
    n_random = max(4, 2048 // block) * block + block // 2 + 1
    x = rs.randn(n_random).astype(np.float32) * np.repeat(
        rs.lognormal(0, 2, -(-n_random // block)), block)[:n_random].astype(np.float32)
    return np.concatenate(parts + [x]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_encode(bits):
    """The reference's Pallas kernel (interpret mode) and oracle for every
    block size of the grid, compiled once per bit width with the codebook
    as an argument."""
    def f(xs, cb):
        out = []
        for x, block in zip(xs, ENCODE_BLOCKS):
            n_blocks = -(-x.shape[0] // block)
            xb = jnp.pad(x, (0, n_blocks * block - x.shape[0])).reshape(n_blocks, block)
            out.append((rops.quantize_blocks(x, cb, block, use_kernel=True, interpret=True),
                        r_quantize_blocks_ref(xb, cb)))
        return out
    return jax.jit(f)


@pytest.mark.kernel
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_quantize_blocks_plain_matches_pallas_and_ref(bits):
    for dtype in ("int", "float", "dynamic", "quantile"):
        base = np.random.RandomState(bits).standard_t(4, 4096).astype(np.float32)
        cb = np.asarray(rc.make_codebook(dtype, bits, tensor=jnp.asarray(base)))
        xs = [_encode_input(cb, block, seed=bits * 31 + block) for block in ENCODE_BLOCKS]
        ref = _ref_encode(bits)([jnp.asarray(x) for x in xs], jnp.asarray(cb))
        for x, block, ((kc, ks), (oc, os_)) in zip(xs, ENCODE_BLOCKS, ref):
            np.testing.assert_array_equal(np.asarray(kc), np.asarray(oc))
            np.testing.assert_array_equal(np.asarray(ks).view(np.int32),
                                          np.asarray(os_).view(np.int32))
            codes, scales = tops.quantize_blocks(_t(x), _t(cb), block)
            assert codes.dtype == torch.int32 and scales.dtype == torch.float32
            assert _bits_equal(codes, _t(kc)), (dtype, block)
            assert _bits_equal(scales.view(torch.int32), _t(np.asarray(ks).view(np.int32)))
            n_blocks = codes.shape[0]
            xb = F.pad(_t(x), (0, n_blocks * block - x.size)).reshape(n_blocks, block)
            pc, ps = tquant.quantize_blocks_plain(xb, _t(cb))
            assert torch.equal(pc, codes) and torch.equal(ps.view(torch.int32),
                                                          scales.view(torch.int32))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built with nvcc and run on the card")


# the tensor-core kernel's edges: rows around its 64-row warpgroup slabs and
# 128-row tiles, columns around its 128-column tiles (and N % 8 != 0), all
# bit widths with blocks that packed words straddle (cpw 10, 6, 5 against
# B = 16, 32, 64), and a grid too small for the card, which splits K
TC_EDGES = [
    (bits, dtype, block, M, K, N)
    for i, (bits, dtype, block) in enumerate([(3, "int", 16), (4, "float", 64), (5, "dynamic", 32),
                                              (6, "float", 16), (8, "int", 64), (7, "dynamic", 16)])
    for j, (M, N) in enumerate([(9, 8), (63, 70), (64, 136), (65, 512), (129, 70), (1024, 136)])
    for K in [(200, 640, 1344)[(i + j) % 3]]
] + [(4, "float", 64, 1024, 3584, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,block,M,K,N",
                         SWEEP[:6] + [(4, "float", 64, 64, 512, 256)] + TC_EDGES)
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


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("dtype", ["int", "float", "dynamic", "quantile"])
def test_quantize_blocks_cuda_kernel_bit_exact(bits, dtype):
    _need_cuda()
    for block in (16, 32, 48, 64, 128, 1024):
        base = np.random.RandomState(bits).standard_t(4, 4096).astype(np.float32)
        cb = t_make_codebook(dtype, bits, tensor=torch.tensor(base, device="cuda"))
        x = torch.tensor(_encode_input(cb.cpu().numpy(), block, seed=bits + block),
                         device="cuda")
        n_blocks = -(-x.numel() // block)
        xb = F.pad(x, (0, n_blocks * block - x.numel())).reshape(n_blocks, block)
        kc, ks = tquant.quantize_blocks_cuda(xb, cb)
        pc, ps = tquant.quantize_blocks_plain(xb, cb)
        torch.cuda.synchronize()
        assert torch.equal(kc, pc) and torch.equal(ks.view(torch.int32), ps.view(torch.int32))


# the tensor-core GEMV's edges: every row count (it always multiplies 8 rows
# and masks the rest), columns around its 16-column blocks, K off its
# chunks of 16 words, every width (3 to 8 bits) over three data types and blocks
GEMV_TC_CASES = [(bits, dtype, block) for bits in tqm.TC_GEMV_BITS
                 for dtype in ("int", "float", "dynamic") for block in (16, 32, 64)]


def _gemv_tc_check(bits, dtype, block, Ms, K, N, seed):
    dev = torch.device("cuda")
    rs = np.random.RandomState(seed)
    op = tops.prepare_operand(torch.tensor(rs.randn(K, N) * 0.05, dtype=torch.float32,
                                           device=dev), bits=bits, dtype=dtype, block_size=block)
    for M in Ms:
        x = torch.tensor(rs.randn(M, K), device=dev).to(torch.bfloat16)
        xp, packed, scales = tops.pad_for_kernel(x, op)
        kw = dict(bits=bits, block_size=block)
        before = tqm.qmatmul_gemv_tc.launches
        y_k = tqm.qmatmul_gemv_tc(xp, packed, scales, op.codebook, **kw).float()
        y_p = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw).float()
        torch.cuda.synchronize()
        assert tqm.qmatmul_gemv_tc.launches == before + 1
        assert float((y_k - y_p).abs().max()) <= BF16_REL_TOL * float(y_p.abs().max()), (M, K, N)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,block", GEMV_TC_CASES)
def test_qmatmul_gemv_tc_matches_plain(bits, dtype, block):
    _need_cuda()
    for i, N in enumerate((8, 16, 17, 70, 512)):
        _gemv_tc_check(bits, dtype, block, (1, 2, 3, 4, 5, 8), (200, 328, 1000)[i % 3], N,
                       seed=bits * 7 + block + i)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block", [(4, 16), (4, 24), (4, 40), (7, 8), (7, 12), (8, 20)])
def test_qmatmul_gemv_tc_single_word_rows(bits, block):
    """Rows whose word count is not a multiple of 4 (read a word at a time),
    and scale blocks of a word count that is not a power of two."""
    _need_cuda()
    K = 200
    bk = (32 // bits) * block // np.gcd(32 // bits, block)
    assert (-(-K // bk) * bk // (32 // bits)) % 4 != 0
    _gemv_tc_check(bits, "float", block, (1, 4, 8), K, 70, seed=bits + block)


def test_gemv_route_sends_bf16_whole_group_blocks_at_3_to_8_bits_to_tensor_cores():
    """gemv_route picks the tensor-core GEMV exactly for bf16 x at 3 to 8
    bits whose scale blocks hold whole groups of 4 codes (at 4 bits whole
    packed words of 8), the CUDA-core one otherwise: f32 x, and blocks that
    split a group."""
    for x_dtype in (torch.float32, torch.bfloat16):
        for bits in range(3, 9):
            for block in (4, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 1024):
                unit = 8 if bits == 4 else 4
                tc = x_dtype == torch.bfloat16 and block % unit == 0
                assert tqm.gemv_route(x_dtype, bits, block) == ("tc" if tc else "simt"), \
                    (x_dtype, bits, block)
    for bits in range(3, 9):   # the serving path and the paper's widths at block 64
        assert tqm.gemv_route(torch.bfloat16, bits, 64) == "tc"
        assert tqm.gemv_route(torch.float32, bits, 64) == "simt"


def test_gemv_routed_widths_match_kernel_source():
    """The bit widths gemv_route sends to the tensor cores are the case
    labels of qgemv_sm90.cu's entry (every width, 3 to 8), whose block check
    is the route's (whole words at 4, 7 and 8 bits, groups of 4 codes at 3,
    5 and 6), and the CUDA-core GEMV, the f32 GEMM and the prefill GEMM
    instantiate every width the wrapper accepts (3 to 8)."""
    import re

    csrc = ROOT / "src" / "repro_torch" / "csrc"
    tc = (csrc / "qgemv_sm90.cu").read_text()
    assert {int(b) for b in re.findall(r"case (\d+): return launch<\1>", tc)} == \
        set(tqm.TC_GEMV_BITS) == set(range(3, 9))
    assert "const int unit = cpw % 4 == 0 ? cpw : 4;" in tc
    assert "block_size % unit != 0" in tc
    for bits in range(3, 9):
        cpw = 32 // bits
        for block in range(1, 130):
            assert tqm.tc_gemv_block_ok(bits, block) == \
                (block % (cpw if cpw % 4 == 0 else 4) == 0), (bits, block)
    simt = (csrc / "qmatmul.cu").read_text()
    assert {int(b) for b in re.findall(r"case (\d+): gemv_warps<T, \1>", simt)} == set(range(3, 9))
    assert {int(b) for b in re.findall(r"case (\d+): return simt_launch<\1>", simt)} == \
        set(range(3, 9))
    sm90 = (csrc / "qgemm_sm90.cu").read_text()
    assert {int(b) for b in re.findall(r"case (\d+): return launch<\1>", sm90)} == \
        set(range(3, 9))


def test_kernel_wrappers_refuse_what_their_kernels_do_not_take():
    """Widths outside 3 to 8 raise in every launcher, and the tensor-core
    GEMV raises for operands gemv_route does not send to it; all before any
    launch, so the CPU shows it."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    scales = torch.zeros(16, 1, dtype=torch.bfloat16)
    for bits in (2, 9):
        packed = torch.zeros(16, 64 // (32 // bits), dtype=torch.int32)
        cb = torch.zeros(2 ** bits)
        for launch in (tqm.qmatmul_gemv, tqm.qmatmul_gemv_simt, tqm.qmatmul_gemm):
            with pytest.raises(ValueError, match="3 to 8 bits"):
                launch(x, packed, scales, cb, bits=bits, block_size=64)
    for xdt, bits, block, K in ((torch.float32, 4, 64, 64), (torch.bfloat16, 5, 6, 6),
                                (torch.bfloat16, 8, 6, 12), (torch.bfloat16, 4, 4, 8),
                                (torch.float32, 3, 64, 320)):
        packed = torch.zeros(16, K // (32 // bits), dtype=torch.int32)
        with pytest.raises(ValueError, match="qmatmul_gemv_tc takes"):
            tqm.qmatmul_gemv_tc(torch.zeros(4, K, dtype=xdt), packed,
                                torch.zeros(16, K // block, dtype=torch.bfloat16),
                                torch.zeros(2 ** bits), bits=bits, block_size=block)


def _prefill_shapes():
    """{arch: [(K, N)]} of every matrix the quantized forward multiplies:
    Qwen2-7B's projections and the paper ladder's (tied embeddings, so no
    quantized head)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.tiny import TINY_FAMILY

    out = {}
    for name in ["qwen2-7b", *TINY_FAMILY]:
        cfg = get_arch(name)
        D, F, H = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
        KV = cfg.n_kv_heads * cfg.head_dim
        out[name] = sorted({(D, H), (D, KV), (H, D), (D, F), (F, D)})
    return out


def test_split_k_step_table_matches_kernel_source():
    """K_STEP is the kernel's KC: the smallest multiple of lcm(cpw, 16) that
    is >= 64; TILE_M/TILE_N are its tile_m<BITS>() and BN."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "qgemm_sm90.cu").read_text()
    assert "return BITS == 4 || BITS == 8 ? 256 : 128;" in src
    assert tqm.TILE_M == {b: 256 if b in (4, 8) else 128 for b in range(3, 9)}
    assert "case 7: return launch<7>" in src
    assert f"constexpr int BN = {tqm.TILE_N};" in src
    for bits, kc in tqm.K_STEP.items():
        cpw = 32 // bits
        step = cpw * 16 // np.gcd(cpw, 16)
        assert kc == -(-64 // step) * step, bits


def test_simt_k_step_table_matches_kernel_source():
    """SIMT_K_STEP is the f32 GEMM's BK: KW words a column, the fewest whole
    uint4s holding at least 32 codes; SIMT_TILE_M/N and SIMT_BLOCKS_PER_SM
    are its SG_BM (8 rows a thread across SG_THREADS / (SG_BN / 8)
    threads), SG_BN and SG_MIN_BLOCKS."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "qmatmul.cu").read_text()
    assert "static constexpr int KW = (32 + 4 * CPW - 1) / (4 * CPW) * 4;" in src
    assert f"constexpr int SG_BN = {tqm.SIMT_TILE_N};" in src
    assert "constexpr int SG_THREADS = 128;" in src
    assert tqm.SIMT_TILE_M == 8 * (128 // (tqm.SIMT_TILE_N // 8))
    assert f"constexpr int SG_MIN_BLOCKS = {tqm.SIMT_BLOCKS_PER_SM};" in src
    for bits, kc in tqm.SIMT_K_STEP.items():
        cpw = 32 // bits
        assert kc == -(-32 // (4 * cpw)) * 4 * cpw, bits


@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_simt_split_plan_for_the_sweep_shapes(bits):
    """For the paper ladder's matrices (the f32 GEMM's shapes at M = 1024)
    and ragged ones: the split never depends on M (it takes no M), leaves
    each block at least MIN_SPLIT_STEPS K steps where it splits, brings the
    blocks of a 1024-row call to SIMT_BLOCKS_PER_SM an SM where the steps
    allow, and is no larger than that needs."""
    sms = tqm.H100_SMS
    target = tqm.SIMT_BLOCKS_PER_SM * sms
    shapes = [s for arch, ks in _prefill_shapes().items() if arch != "qwen2-7b" for s in ks]
    for K, N in shapes + [(200, 70), (3584, 512), (96, 65), (18944, 3584)]:
        for block in (16, 32, 64):
            cpw = 32 // bits
            bk = cpw * block // np.gcd(cpw, block)
            Kp = -(-K // bk) * bk
            steps = -(-Kp // tqm.SIMT_K_STEP[bits])
            tiles = -(-N // tqm.SIMT_TILE_N) * (tqm.SIMT_SPLIT_ROWS // tqm.SIMT_TILE_M)
            split = tqm.simt_split(N, Kp, bits, sms)
            assert split >= 1
            if split > 1:
                assert steps // split >= tqm.MIN_SPLIT_STEPS and tiles < target
                assert tiles * (split - 1) < target
            if tiles < target and split == 1:
                assert steps // 2 < tqm.MIN_SPLIT_STEPS
            if tiles < target and steps // tqm.MIN_SPLIT_STEPS >= -(-target // tiles):
                assert tiles * split >= target
            assert tqm.split_workspace_shape(1024, N, split) == \
                ((split, 1024, N) if split > 1 else None)


@pytest.mark.parametrize("arch", list(_prefill_shapes()))
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_split_k_plan_for_main_path_shapes(arch, bits):
    """For every (M, K, N, bits) the Qwen2-7B prefill and the paper sweep
    launch at M = 1024 (K padded as kernels/ops pads it for each block size
    the sweep uses): the split divides the K steps, leaves each block at
    least MIN_SPLIT_STEPS of them, brings the block count of one row tile
    to the SM count when any allowed split can (the split does not depend
    on M), and sizes the workspace [split, M, N] and the x tile images."""
    M = 1024
    sms = tqm.H100_SMS
    for K, N in _prefill_shapes()[arch]:
        for block in (16, 32, 64, 128, 256, 1024):
            cpw = 32 // bits
            bk = cpw * block // np.gcd(cpw, block)
            Kp = -(-K // bk) * bk
            steps = -(-Kp // tqm.K_STEP[bits])
            tiles = -(-N // tqm.TILE_N)
            split = tqm.split_k(N, Kp, bits, sms)
            allowed = [s for s in range(1, steps + 1) if steps % s == 0
                       and (s == 1 or steps // s >= tqm.MIN_SPLIT_STEPS)]
            assert split in allowed, (K, N, block, split)
            if tiles >= sms:
                assert split == 1
            elif any(tiles * s >= sms for s in allowed):
                assert tiles * split >= sms
                assert all(tiles * s < sms for s in allowed if s < split)
            else:
                assert split == allowed[-1]
            shape = tqm.split_workspace_shape(M, N, split)
            assert shape == ((split, M, N) if split > 1 else None)
            assert tqm.x_tiles_shape(M, Kp, bits) == (
                -(-M // tqm.TILE_M[bits]) * tqm.TILE_M[bits], steps * tqm.K_STEP[bits])


def test_split_k_plan_of_qwen_prefill():
    """The split counts the column tiles of one row tile (128 columns): the
    k/v projections (N = 512, 4 tiles) and every N = 3584 projection (28
    tiles) split K; 56 steps at K = 3584 and 296 at K = 18944.  28 tiles
    reach 132 blocks at 7 and 8; 4 tiles reach none, so the k/v projections
    take the largest split, 28.  Only gate/up (148 tiles) run unsplit."""
    assert tqm.split_k(512, 3584, 4) == 28
    assert tqm.split_k(3584, 3584, 4) == 7
    assert tqm.split_k(3584, 18944, 4) == 8
    assert tqm.split_k(18944, 3584, 4) == 1


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
    for sub in ("paper", "train", "optim", "data", "kernels", "core"):
        assert any(f.parent.name == sub for f in files), sub
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
