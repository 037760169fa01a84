"""The port's k-bit codec (repro_torch.core) against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both packages.  The
bar: codebooks, packed words, codes and bf16 scale bits are identical to
the reference for k in 3..8 x {int, float, dynamic} x block {16, 64, 128},
word tails and the odd-bit row repack included; dequantized values are
identical too.  The quantile codebook is data dependent and computed by
two quantile implementations, so it is held within 1e-6, and its codes
are identical when both encoders get the reference's codebook.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import blockwise as rb  # noqa: E402
from repro.core import codebooks as rc  # noqa: E402
from repro.core import packing as rp  # noqa: E402
from repro.core import qtensor as rq  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import blockwise as tb  # noqa: E402
from repro_torch.core import codebooks as tc  # noqa: E402
from repro_torch.core import packing as tp  # noqa: E402
from repro_torch.core import qtensor as tq  # noqa: E402

torch.set_num_threads(2)

BITS = [3, 4, 5, 6, 7, 8]
DTYPES = ["int", "float", "dynamic"]


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _same_bits(port: torch.Tensor, ref) -> bool:
    """Bit equality of a port tensor and a reference array."""
    ref_t = _t(ref)
    if port.dtype != ref_t.dtype or tuple(port.shape) != tuple(ref_t.shape):
        return False
    if port.dtype == torch.bfloat16:
        return torch.equal(port.view(torch.int16), ref_t.view(torch.int16))
    return torch.equal(port, ref_t)


@functools.lru_cache(maxsize=None)
def _ref_encode_pack(bits, block):
    """The reference's encode + pack, compiled once per (bits, block) with
    the codebook as an argument (eager jax compiles every op per shape,
    which would dominate this file's run time)."""
    def f(x, cb):
        q = rb.encode(x, cb, block)
        return q.codes, q.scales, rp.pack(q.codes.reshape(-1), bits)
    return jax.jit(f)


@pytest.mark.parametrize("bits", BITS)
def test_static_codebooks_equal_reference(bits):
    for dtype in DTYPES:
        ref = np.asarray(rc.make_codebook(dtype, bits))
        port = tc.make_codebook(dtype, bits, device="cpu")
        assert port.dtype == torch.float32
        np.testing.assert_array_equal(port.numpy(), ref)
        np.testing.assert_array_equal(tc.codebook_boundaries(port).numpy(),
                                      np.asarray(rc.codebook_boundaries(jnp.asarray(ref))))


@pytest.mark.parametrize("bits", BITS)
def test_int_codebook_equals_tpu_kernel_arithmetic(bits):
    """The CUDA kernels decode int codes through the codebook; the TPU
    kernel computes clip(c - h, -h, h) / h.  The two must agree bit for bit."""
    from repro.kernels.qmatmul import _dequant_codes

    codes = jnp.arange(2**bits, dtype=jnp.uint32)[None, :]
    ref = np.asarray(_dequant_codes(codes, None, bits, "int"))[0]
    np.testing.assert_array_equal(tc.make_codebook("int", bits, device="cpu").numpy(), ref)


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_quantile_codebook_within_1e6_and_codes_identical(bits):
    x = np.random.RandomState(bits).standard_t(4, size=(40, 600)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t: rc.quantile_codebook(t, bits))(jnp.asarray(x)))
    port = tc.make_codebook("quantile", bits, tensor=_t(x))
    assert float(np.abs(port.numpy() - ref).max()) <= 1e-6
    codes, scales, _ = _ref_encode_pack(bits, 64)(jnp.asarray(x), jnp.asarray(ref))
    q_port = tb.encode(_t(x), _t(ref), 64)
    assert _same_bits(q_port.codes, codes)
    assert _same_bits(q_port.scales, scales)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", [29, 333])
def test_pack_unpack_words_identical(bits, n):
    codes = np.random.RandomState(n * 10 + bits).randint(0, 2**bits, (3, n)).astype(np.uint8)

    def ref(c):
        words = rp.pack(c, bits)
        return words, rp.unpack(words, bits, n)

    ref_words, ref_codes = jax.jit(ref)(jnp.asarray(codes))
    port_words = tp.pack(_t(codes), bits)
    assert _same_bits(port_words, ref_words)
    back = tp.unpack(port_words, bits, n)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_codes))


@pytest.mark.parametrize("block", [16, 64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", BITS)
def test_encode_pack_bit_exact(bits, dtype, block):
    """Codes, bf16 scale bits and packed words over a tensor whose size
    divides neither the block nor the packing word (padding + word tail)."""
    rs = np.random.RandomState(1000 * bits + block)
    x = (rs.randn(37, 50) * rs.lognormal(0, 1, (37, 1))).astype(np.float32)
    codes, scales, words = _ref_encode_pack(bits, block)(jnp.asarray(x),
                                                        rc.make_codebook(dtype, bits))
    q = tb.encode(_t(x), tc.make_codebook(dtype, bits, device="cpu"), block)
    assert _same_bits(q.codes, codes)
    assert _same_bits(q.scales, scales)
    assert _same_bits(tp.pack(q.codes.reshape(-1), bits), words)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_tensor_structured_bit_exact(bits):
    """quantize_tensor with a batch dim, to_structured (cols = 128 leaves a
    word tail, and a row repack, at 3/5/6/7 bits) and dequantize_tensor."""
    dtype = DTYPES[bits % 3]
    block = 16 if bits % 2 else 64
    w = (np.random.RandomState(bits).randn(2, 24, 128) * 0.05).astype(np.float32)

    def ref(w):
        qt = rq.to_structured(rq.quantize_tensor(w, bits=bits, dtype=dtype,
                                                 block_size=block, batch_dims=1))
        return qt, rq.dequantize_tensor(qt, out_dtype=jnp.float32)

    qt_ref, deq_ref = jax.jit(ref)(jnp.asarray(w))
    qt_port = tq.to_structured(tq.quantize_tensor(_t(w), bits=bits, dtype=dtype,
                                                  block_size=block, batch_dims=1))
    assert qt_port.structured and qt_ref.structured
    for field in ("packed", "scales", "codebook"):
        assert _same_bits(getattr(qt_port, field), getattr(qt_ref, field)), field
    assert qt_port.orig_dtype == qt_ref.orig_dtype
    np.testing.assert_array_equal(
        tq.dequantize_tensor(qt_port, out_dtype=torch.float32).numpy(), np.asarray(deq_ref))


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_flat_fallback_and_carry_across(bits):
    """cols not divisible by the block keep flat storage; a reference QT
    carried across dequantizes to the same values as the port's own."""
    w = (np.random.RandomState(bits).randn(20, 72) * 0.1).astype(np.float32)
    qt_ref = jax.jit(lambda t: rq.to_structured(rq.quantize_tensor(t, bits=bits, block_size=64)))(
        jnp.asarray(w))
    qt_port = tq.to_structured(tq.quantize_tensor(_t(w), bits=bits, block_size=64))
    assert not qt_ref.structured and not qt_port.structured
    assert _same_bits(qt_port.packed, qt_ref.packed)
    carried = interop.params_from_reference({"w": qt_ref}, device="cpu")["w"]
    assert isinstance(carried, tq.QuantizedTensor)
    np.testing.assert_array_equal(tq.dequantize_tensor(carried, torch.float32).numpy(),
                                  tq.dequantize_tensor(qt_port, torch.float32).numpy())


def test_centering_and_outliers_not_in_this_slice():
    x = torch.zeros(4, 64)
    with pytest.raises(NotImplementedError):
        tq.quantize_tensor(x, bits=4, centering=True)
    with pytest.raises(NotImplementedError):
        tq.quantize_tensor(x, bits=4, outlier_idx=torch.zeros(1, 1, dtype=torch.int32))
