"""The port's centering (App. B) and proxy quantization (§3) against the JAX
package's.

Inputs are drawn with numpy from a seed (or trained by the port and carried
across as numpy) and go through both packages.  The bars:
  * block means (``blockwise.mean_xla``): the f32 bits of ``jnp.mean`` over
    the same blocks at B = 64, 128 and 1024 (and at block sizes that need
    XLA's padding), the bf16 means and the codes of the centered encode
    identical.  ``torch.mean`` sums in another order and differs from
    ``jnp.mean`` in the last bit of most blocks (fault C2);
  * ``quantize_tensor`` with outliers on axis 0 and -1 and with centering:
    packed words, scales, means, outlier values and indices bit for bit;
    ``dequantize_tensor`` identical; ``quantization_error`` within 1e-6
    relative (an f32 mean of squares over the tensor, summed in another
    order: up to 2.3e-7, ``tests/torch_parity_gaps.py``);
  * ``quantize_params`` of trained tiny-160k and tiny-650k and of a GQA
    variant (G = 2, which repeats ``wo``'s producer std over the group)
    with ``outlier_pct=0.02`` and with centering: every leaf of the
    quantized trees (and so the outlier index sets) bit for bit,
    ``bits_report`` equal, perplexity within 1e-3 relative (the bar of
    test_torch_paper.py: the model's bf16 roundings, not the codec);
  * ``std_xla`` (the producer std): the f32 bits of ``jnp.std`` (the same
    sums in the same order, the variance divided, the root correctly
    rounded) on seeded matrices and on every producer weight of the outlier
    trees below.  Its root was ``torch.sqrt`` in f32, which on the CPU is
    not correctly rounded and was a last bit off on a few units (fault C2's
    remainder).  Within 2 ulps elsewhere: on wide matrices with a per-row
    offset (1344 columns) the variance's own sum still differs on ~1 % of
    units, and under an outer ``jax.jit`` the reference multiplies by the
    reciprocal count instead of dividing.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from benchmarks import common as rcommon  # noqa: E402
from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.core import blockwise as rb  # noqa: E402
from repro.core import proxy as rproxy  # noqa: E402
from repro.core import qtensor as rq  # noqa: E402
from repro.core.codebooks import make_codebook as r_make_codebook  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import bits_report as r_bits_report  # noqa: E402
from repro.models.quantize import dequantize_params as r_dequantize_params  # noqa: E402
from repro.models import quantize as rquant  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving import perplexity as r_perplexity  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.core import blockwise as tb  # noqa: E402
from repro_torch.core import proxy as tproxy  # noqa: E402
from repro_torch.core import qtensor as tq  # noqa: E402
from repro_torch.core.codebooks import make_codebook  # noqa: E402
from repro_torch.models import quantize as tquant  # noqa: E402
from repro_torch.models.quantize import bits_report, quantize_params  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(2)

PPL_REL = 1e-3
ERR_REL = 1e-6
STD_ULPS = 2
#: the seeded f32 matrices (x 0.02) on which C2's remainder was pinned down
STD_SHAPES = [(256, 512), (100, 300), (1000, 200), (64, 1024), (4096, 64)]


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _bits(a) -> np.ndarray:
    """The raw bits of a port tensor or a reference array, as integers."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.int32) if a.dtype == torch.float32 else a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _same_bits(port, ref) -> bool:
    p, r = _bits(port), _bits(ref)
    return p.shape == r.shape and np.array_equal(p, r)


def _blocks(n, block, seed):
    """Seeded f32 blocks like trained weights (std 0.02) with a per-block
    offset, so the means are not all near 0."""
    rs = np.random.RandomState(seed)
    return (rs.randn(n, block) * 0.02 + rs.randn(n, 1) * 0.01).astype(np.float32)


# -- C2: the block means ------------------------------------------------------

@pytest.mark.parametrize("block", [64, 128, 1024])
def test_block_means_bit_exact_to_jnp_mean(block):
    """The centered encode's means: f32 bits of jnp.mean, bf16 means and the
    codes of the centered blocks identical (fault C2: torch.mean's order)."""
    x = _blocks(2000 if block < 1024 else 400, block, seed=block)
    ref_mean = np.asarray(jnp.mean(jnp.asarray(x), axis=1))
    port_mean = tb.mean_xla(torch.from_numpy(x), 1)
    assert _same_bits(port_mean, ref_mean)
    cb = r_make_codebook("int", 4)
    ref = jax.jit(lambda a, c: rb.encode(a, c, block, centering=True))(jnp.asarray(x), cb)
    port = tb.encode(torch.from_numpy(x), make_codebook("int", 4, device="cpu"), block, centering=True)
    assert _same_bits(port.means, ref.means)
    assert _same_bits(port.scales, ref.scales)
    assert np.array_equal(port.codes.numpy(), np.asarray(ref.codes))


@pytest.mark.parametrize("n", [16, 33, 48, 100, 1100, 4096])
def test_sum_xla_pads_and_nests_as_xla(n):
    """Lengths under one window, off a multiple of it (XLA pads on both
    sides) and past 32 windows (a second level of windows)."""
    x = _blocks(300, n, seed=n)
    assert _same_bits(tb.mean_xla(torch.from_numpy(x), 1),
                      np.asarray(jnp.mean(jnp.asarray(x), axis=1)))
    # the other axis (the producer std reduces over rows)
    assert _same_bits(tb.mean_xla(torch.from_numpy(x.T.copy()), 0),
                      np.asarray(jnp.mean(jnp.asarray(x.T), axis=0)))


@pytest.mark.parametrize("rows,cols", [(64, 192), (192, 64), (448, 1344)])
def test_producer_std_near_jnp_std(rows, cols):
    w = _blocks(rows, cols, seed=rows + cols)
    ref = np.asarray(jnp.std(jnp.asarray(w), axis=0))
    port = tproxy.hidden_unit_std(torch.from_numpy(w)).numpy()
    ulps = np.abs(port.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= STD_ULPS, ulps.max()


@pytest.mark.parametrize("rows,cols", STD_SHAPES)
def test_hidden_unit_std_bit_exact_to_jnp_std(rows, cols):
    """C2's remainder: the port's variance is ``jnp.var``'s bit for bit, and
    its root, taken in f64 and rounded once, is the correctly rounded f32
    root that XLA takes, so every unit's std is ``jnp.std``'s."""
    w = (np.random.RandomState(rows * 7 + cols).randn(rows, cols) * 0.02).astype(np.float32)
    port = tproxy.hidden_unit_std(torch.from_numpy(w))
    assert _same_bits(port, np.asarray(jnp.std(jnp.asarray(w), axis=0)))
    assert _same_bits(port, np.asarray(rproxy.hidden_unit_std(jnp.asarray(w))))
    # what the f32 root gave: the same variance, a last bit off on a few units
    var = torch.from_numpy(np.asarray(jnp.var(jnp.asarray(w), axis=0)))
    assert _same_bits(torch.sqrt(var.double()).float(), port)


@pytest.mark.parametrize("name", ["tiny-160k", "tiny-650k", "gqa"])
def test_producer_stds_of_outlier_trees_bit_exact(name):
    """Every producer weight of the proxy trees that
    ``test_quantize_params_matches_reference`` quantizes (w_up, wv, w_down,
    wo): the port's std over the input dim has the bits of the reference's
    ``_producer_std`` run op by op (``jnp.std``, which divides the variance).
    Inside an outer ``jax.jit`` XLA turns that division into a multiply by
    the reciprocal, which moves the last bit where the count is not a power
    of two; the tree tests hold the outlier index sets the stds pick."""
    weights = _gqa_pair()[2] if name == "gqa" else _trained(name)
    layer = weights["stack"][0]
    mats = [layer[m][k]["w"] for m, k in (("ffn", "w_up"), ("mixer", "wv"),
                                          ("ffn", "w_down"), ("mixer", "wo"))]
    for w in mats:
        port = tquant._producer_std(torch.from_numpy(np.asarray(w)))
        assert _same_bits(port, np.asarray(jnp.std(jnp.asarray(w), axis=-2)))
        assert _same_bits(port, np.asarray(rquant._producer_std(jnp.asarray(w))))


def test_outlier_indices_topk_stable_ties():
    std = np.array([[0.5, 0.9, 0.9, 0.1, 0.9, 0.2]], np.float32)
    for k in (1, 2, 3, 4):
        assert np.array_equal(tproxy.outlier_indices_topk(torch.from_numpy(std), k).numpy(),
                              np.asarray(rproxy.outlier_indices_topk(jnp.asarray(std), k)))
    assert np.array_equal(tproxy.outlier_indices(torch.from_numpy(std[0]), 0.34).numpy(),
                          np.asarray(rproxy.outlier_indices(jnp.asarray(std[0]), 0.34)))


# -- quantize_tensor with outliers and means ----------------------------------

CASES = [
    # (shape, batch dims, outlier axis or None, bits, centering)
    ((48, 128), 0, -1, 4, False),      # a transposed-stored matrix's outlier inputs
    ((2, 48, 128), 1, 0, 3, False),    # outlier rows, batched
    ((48, 128), 0, None, 3, True),     # centered rows of blocks, restructured
    ((48, 128), 0, -1, 5, True),       # both
    ((20, 72), 0, -1, 4, True),        # flat: blocks straddle rows
    ((2, 40, 64), 1, 0, 8, True),
]


@pytest.mark.parametrize("shape,bd,axis,bits,centering", CASES)
def test_quantize_tensor_outliers_and_centering_bit_exact(shape, bd, axis, bits, centering):
    rs = np.random.RandomState(sum(shape) + bits)
    x = (rs.randn(*shape) * 0.05).astype(np.float32)
    kw = dict(bits=bits, block_size=64, batch_dims=bd, centering=centering)
    idx = None
    if axis is not None:
        n_items = int(np.prod(shape[:bd])) if bd else 1
        h = shape[bd:][axis]
        idx = np.stack([np.sort(rs.choice(h, 3, replace=False)) for _ in range(n_items)])
        idx = idx.astype(np.int32).reshape(shape[:bd] + (3,))
        kw.update(outlier_axis=axis)
    ref = rq.to_structured(rq.quantize_tensor(
        jnp.asarray(x), outlier_idx=None if idx is None else jnp.asarray(idx), **kw))
    port = tq.to_structured(tq.quantize_tensor(
        _t(x), outlier_idx=None if idx is None else _t(idx), **kw))
    assert port.structured == ref.structured
    for f in ("packed", "scales", "means", "outlier_vals", "outlier_idx"):
        r, p = getattr(ref, f), getattr(port, f)
        assert (p is None) == (r is None), f
        if r is not None:
            assert _same_bits(p, r), f
    np.testing.assert_array_equal(tq.dequantize_tensor(port, torch.float32).numpy(),
                                  np.asarray(rq.dequantize_tensor(ref, jnp.float32)))
    r_err = float(rq.quantization_error(jnp.asarray(x), ref))
    t_err = float(tq.quantization_error(_t(x), port))
    assert abs(t_err - r_err) <= ERR_REL * r_err
    assert dataclasses.asdict(port.bits_breakdown()) == dataclasses.asdict(ref.bits_breakdown())
    # a reference QT carried across dequantizes as the port's own
    carried = interop.params_from_reference({"w": ref}, device="cpu")["w"]
    assert torch.equal(tq.dequantize_tensor(carried, torch.float32),
                       tq.dequantize_tensor(port, torch.float32))


@pytest.mark.parametrize("centering", [False, True])
def test_quantize_dequantize_and_encode_chunked(centering):
    x = _blocks(37, 64, seed=5).reshape(-1)[:2300]
    cb = r_make_codebook("float", 4)
    ref = rb.quantize_dequantize(jnp.asarray(x), cb, 64, centering=centering)
    port = tb.quantize_dequantize(torch.from_numpy(x), make_codebook("float", 4, device="cpu"), 64,
                                  centering=centering)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    whole = tb.encode(torch.from_numpy(x), make_codebook("float", 4, device="cpu"), 64, centering=centering)
    chunked = tb.encode_chunked(torch.from_numpy(x), make_codebook("float", 4, device="cpu"), 64,
                                chunk_blocks=8, centering=centering)
    assert torch.equal(whole.codes, chunked.codes)
    assert torch.equal(whole.scales.view(torch.int16), chunked.scales.view(torch.int16))
    if centering:
        assert torch.equal(whole.means.view(torch.int16), chunked.means.view(torch.int16))


# -- whole trees ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trained(name):
    """Weights trained a few steps by the port, as numpy for both packages."""
    state, _ = tloop.train(get_arch(name), steps=30, batch=8, seq_len=64, device="cpu",
                           log=lambda *_: None)
    return tree_map(lambda t: t.numpy(), state.params)


def _gqa_pair():
    """tiny-650k with 2 KV heads for 4 query heads (G = 2), random weights
    from the reference's init, for both packages."""
    rcfg = dataclasses.replace(r_get_arch("tiny-650k"), n_kv_heads=2)
    tcfg = dataclasses.replace(get_arch("tiny-650k"), n_kv_heads=2)
    weights = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(3), rcfg))
    return rcfg, tcfg, weights


METHODS = {"proxy2%": dict(bits=3, dtype="float", block_size=64, outlier_pct=0.02),
           "centered": dict(bits=4, dtype="int", block_size=64, centering=True)}


def _assert_trees_equal(port_tree, ref_tree):
    carried = interop.flatten(interop.params_from_reference(ref_tree, device="cpu"))
    own = interop.flatten(port_tree)
    assert sorted(carried) == sorted(own)
    bad = [k for k in carried if not _same_bits(own[k], carried[k])]
    assert not bad, bad


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("name", ["tiny-160k", "tiny-650k", "gqa"])
def test_quantize_params_matches_reference(name, method):
    """Every quantized leaf (codes, scales, means, outlier values and index
    sets), bits_report and perplexity against the reference's."""
    if name == "gqa":
        rcfg, tcfg, weights = _gqa_pair()
    else:
        rcfg, tcfg, weights = r_get_arch(name), get_arch(name), _trained(name)
    rq_cfg, tq_cfg = RQuantConfig(**METHODS[method]), QuantConfig(**METHODS[method])
    r_params = jax.tree.map(jnp.asarray, weights)
    t_params = interop.params_from_reference(weights, device="cpu")
    r_q = jax.jit(lambda p: r_quantize_params(p, rq_cfg, rcfg))(r_params)
    t_q = quantize_params(t_params, tq_cfg, tcfg, device="cpu")
    _assert_trees_equal(t_q, r_q)
    if method == "proxy2%":   # the GQA wo's outliers come from wv's repeated stds
        wo = t_q["stack"][0]["mixer"]["wo"]["w"]
        assert wo.outlier_idx is not None and wo.outlier_idx.shape[-1] >= 1
    assert bits_report(t_q) == r_bits_report(r_q)
    toks = np.asarray(rcommon.eval_tokens(rcfg))
    r_ppl = r_perplexity(jax.jit(r_dequantize_params)(r_q), rcfg, jnp.asarray(toks))
    t_ppl, t_bpp, t_tot = tcommon.evaluate_quant(tcfg, t_params, tq_cfg, _t(toks))
    assert abs(t_ppl / r_ppl - 1) <= PPL_REL, (t_ppl, r_ppl)
    rep = r_bits_report(r_q)
    assert (t_bpp, t_tot) == (rep["avg_bits_per_param"], rep["total_bits_ideal"])
