"""The port's encode-to-stored-form (``kernels/quantize.quantize_pack``) and
its fused decode attention over the packed KV cache
(``kernels/kv_attention.decode_attention_packed``) against the JAX package.

On the CPU each wrapper runs its plain version:
  * ``quantize_pack``: packed words and scale bits identical to the
    reference's ``to_structured(quantize_tensor(...))`` over bits 3..8 x B
    {16, 64, 128} x {int, float, dynamic, quantile} x {row-major, transposed
    as models/quantize stores weights} x {bf16, f32} inputs, with odd row
    counts and columns that leave a word tail (cpw not dividing B or cols);
    ``quantize_params`` sends every structured item through it;
  * ``decode_attention_packed``: within 2^-6 * max|ref| (two bf16 ulps at a
    row's max) of the reference's ``decode_attention`` over a packed kv4 and
    kv8 cache with empty slots and ``pos`` short of the last slot, per (batch
    row, head), also under a logit soft-cap and a sliding window; and ``Engine.generate`` at kv4 and kv8 gives the reference's
    greedy tokens, with one fused-attention call a layer and step.
The wrappers' refusals show on the CPU.  Cases marked ``cuda`` hold each
kernel against its plain version on the card and skip without one.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import qtensor as rq  # noqa: E402
from repro.kernels import kv_dequant as rkv  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import blockwise as tb  # noqa: E402
from repro_torch.core import packing as tp  # noqa: E402
from repro_torch.core import qtensor as tq  # noqa: E402
from repro_torch.core.codebooks import make_codebook  # noqa: E402
from repro_torch.kernels import kv_attention as tka  # noqa: E402
from repro_torch.kernels import kv_dequant as tkv  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

torch.set_num_threads(2)

ATT_TOL = 2.0 ** -6          # two bf16 ulps at the row's max
DTYPES = ("int", "float", "dynamic", "quantile")
# (block, cols): cols a multiple of the block, and not of cpw = 10, 6 or 5,
# so rows end in a word tail; at 3, 5, 6 bits words straddle blocks too
PACK_SHAPES = {16: 112, 64: 192, 128: 128}
ROWS = 37


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        return b.dtype == a.dtype and torch.equal(a.view(torch.int16), b.view(torch.int16))
    return a.dtype == b.dtype and torch.equal(a, b)


def _pack_input(block: int, seed: int) -> np.ndarray:
    """[ROWS, cols] f32: rows of mixed scale, one all-zero row (scale
    1e-12) and one row whose values all sit on a codebook midpoint grid."""
    cols = PACK_SHAPES[block]
    rs = np.random.RandomState(seed)
    w = rs.randn(ROWS, cols) * rs.lognormal(0, 1.5, (ROWS, 1))
    w[3] = 0.0
    w[5] = np.round(rs.randn(cols) * 8) / 16
    return w.astype(np.float32)


def _flat_chain(item: torch.Tensor, cb: torch.Tensor, bits: int, block: int):
    """The route quantize_pack replaced: the flat encode of a 2-D item,
    its flat words, then to_structured's row repack where rows hold whole
    blocks."""
    q = tb.encode(item, cb, block)
    qt = tq.QuantizedTensor(packed=tp.pack(q.codes.reshape(-1), bits), scales=q.scales,
                            means=None, codebook=cb, outlier_vals=None, outlier_idx=None,
                            quant_shape=tuple(item.shape), bits=bits, block_size=block,
                            dtype_name="float", centering=False)
    return tq.to_structured(qt)


@functools.lru_cache(maxsize=None)
def _ref_structured(bits: int, block: int):
    """The reference's stored form of one item for each data type, from f32
    and bf16 inputs: one compilation per (bits, block)."""
    def f(w32, w16):
        out = {}
        for dtype in DTYPES:
            for name, w in (("float32", w32), ("bfloat16", w16)):
                qt = rq.to_structured(rq.quantize_tensor(w, bits=bits, dtype=dtype,
                                                         block_size=block))
                out[dtype, name] = (qt.packed, qt.scales, qt.codebook)
        return out
    return jax.jit(f)


@pytest.mark.parametrize("block", sorted(PACK_SHAPES))
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_quantize_pack_plain_bit_exact_with_reference(bits, block):
    w = _pack_input(block, seed=bits * 13 + block)
    ref = _ref_structured(bits, block)(jnp.asarray(w), jnp.asarray(w, jnp.bfloat16))
    for dtype in DTYPES:
        for name in ("float32", "bfloat16"):
            packed, scales, cb = (_t(a) for a in ref[dtype, name])
            x = torch.from_numpy(w).to(getattr(torch, name))
            # row-major as stored, and the [In, Out] weight models/quantize
            # keeps, whose transpose is the item
            for stored, flipped in ((x, False), (x.T.contiguous(), True)):
                p, s = tquant.quantize_pack_plain(stored, cb, bits=bits, block_size=block,
                                                  transposed=flipped)
                assert _bits_equal(p, packed) and _bits_equal(s, scales), (dtype, name, flipped)
                # quantize_tensor, from the view quantize_params holds,
                # equals the flat encode and repack it replaces; with a
                # static codebook, the reference too (the quantile codebook
                # comes from two quantile implementations, within 1e-6:
                # test_torch_codec.py)
                view = stored.T if flipped else stored
                qt = tq.quantize_tensor(view, bits=bits, dtype=dtype, block_size=block)
                old = _flat_chain(view, qt.codebook, bits, block)
                assert qt.structured and old.structured and qt.packed.shape == packed.shape
                for field in ("packed", "scales"):
                    assert _bits_equal(getattr(qt, field), getattr(old, field)), field
                if dtype != "quantile":
                    assert _bits_equal(qt.codebook, cb)
                    assert _bits_equal(qt.packed, packed) and _bits_equal(qt.scales, scales)


def test_structured_route_keeps_flat_items_flat():
    """cols % B != 0 keeps the flat layout and the flat encode, as
    to_structured does; batched items are encoded one at a time."""
    w = torch.randn(3, 20, 72)
    cb = make_codebook("float", 4, device="cpu")
    flat = tq.quantize_tensor(w, bits=4, block_size=64, batch_dims=1)
    assert not flat.structured and tq.to_structured(flat) is flat
    assert _bits_equal(flat.packed, torch.stack([_flat_chain(i, cb, 4, 64).packed for i in w]))
    rows = tq.quantize_tensor(w, bits=6, block_size=24, batch_dims=1)
    assert rows.structured and tuple(rows.packed.shape) == (3, 20, 15)
    cb6 = make_codebook("float", 6, device="cpu")
    assert _bits_equal(rows.packed, torch.stack([_flat_chain(i, cb6, 6, 24).packed for i in w]))


def test_quantize_params_sends_structured_items_through_quantize_pack(monkeypatch):
    """Every matrix of the tiny ladder's smallest model rows into whole
    blocks at B = 64: 7 items a layer, each one quantize_pack call (on the
    card, one kernel launch), and the stored tree is already structured."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params

    calls = []
    real = tquant.quantize_pack

    def spy(item, *args, **kwargs):
        calls.append((tuple(item.shape), kwargs["transposed"]))
        return real(item, *args, **kwargs)

    monkeypatch.setattr(tquant, "quantize_pack", spy)
    cfg = get_arch("tiny-160k")
    q = quantize_params(lm.init_params(cfg, device="cpu", dtype=torch.bfloat16),
                        QuantConfig(bits=4), cfg, device="cpu")
    assert len(calls) == 7 * cfg.n_layers and all(t for _, t in calls)
    stack = q["stack"][0]
    for group, names in (("mixer", ("wq", "wk", "wv", "wo")), ("ffn", ("w_gate", "w_up",
                                                                        "w_down"))):
        for n in names:
            assert stack[group][n]["w"].structured


def test_quantize_pack_refuses_what_it_does_not_take():
    cb = make_codebook("float", 4, device="cpu")
    x = torch.zeros(8, 64)
    for fn in (tquant.quantize_pack, tquant.quantize_pack_plain):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.T.contiguous().T[:, :32], cb, bits=4, block_size=16)
        with pytest.raises(ValueError, match="3 to 8 bits"):
            fn(x, make_codebook("int", 2, device="cpu"), bits=2, block_size=16)
        with pytest.raises(ValueError, match="3 to 8 bits"):
            fn(x, torch.zeros(512), bits=9, block_size=16)
        with pytest.raises(ValueError, match="cols % B"):
            fn(x, cb, bits=4, block_size=48)
        with pytest.raises(ValueError, match="2-D bf16 or f32"):
            fn(x.to(torch.float16), cb, bits=4, block_size=16)


def test_pack_segment_starts_on_words_and_blocks():
    """A warp's segment is a multiple of lcm(B, cpw), at most 512 columns
    unless one lcm is longer, and shorter only to give the grid warps."""
    for bits in range(3, 9):
        cpw = 32 // bits
        for block in (16, 32, 48, 64, 128, 1024):
            for rows, cols in ((3584, 3584), (512, 3584), (18944, 3584), (37, 1024 * 3)):
                seg = tquant.pack_segment(rows, cols, bits, block)
                unit = np.lcm(block, cpw)
                assert seg % unit == 0 and (seg <= 512 or seg == unit)
    assert tquant.pack_segment(152064, 3584, 4, 64) == 512     # lm_head: 4752 x 7 warps
    assert tquant.pack_segment(512, 3584, 4, 64) == 64         # wk/wv: 16 x 56 warps


# ---------------------------------------------------------------------------
# the fused decode attention
# ---------------------------------------------------------------------------

def _kv_case(bits, B, S, K, G, Dh, n_filled, seed, block=64):
    """A packed cache (reference encode) with slots past n_filled empty and
    a q, as numpy; the reference's spec and the port's."""
    rs = np.random.RandomState(seed)
    feat = K * Dh
    k = rs.randn(B, S, feat) * rs.lognormal(0, 0.5, (B, S, 1))
    v = rs.randn(B, S, feat)
    r_spec = rkv.KVQuantSpec(bits=bits, block_size=block, dtype_name="float")
    kp, ks = rkv.encode_rows(jnp.asarray(k, jnp.bfloat16), r_spec)
    vp, vs = rkv.encode_rows(jnp.asarray(v, jnp.bfloat16), r_spec)
    pos_arr = np.where(np.arange(S) < n_filled, np.arange(S), -1).astype(np.int32)
    q = np.asarray(jnp.asarray(rs.randn(B, K * G, Dh) * 2, jnp.bfloat16))
    cache = {"k_packed": kp, "k_scales": ks, "v_packed": vp, "v_scales": vs,
             "pos": jnp.asarray(pos_arr)}
    t_spec = tkv.KVQuantSpec(bits=bits, block_size=block, dtype_name="float")
    return q, cache, r_spec, t_spec


def _port_cache(cache):
    return {k: _t(v) for k, v in cache.items()}


ATT_CASES = [(bits, B, S, n_filled, pos)
             for bits in (4, 8)
             for B, S, n_filled, pos in ((1, 1, 1, 0), (4, 17, 17, 16), (2, 40, 30, 25),
                                         (1, 33, 0, 5))]


@pytest.mark.parametrize("bits,B,S,n_filled,pos", ATT_CASES)
def test_decode_attention_packed_plain_matches_reference(bits, B, S, n_filled, pos):
    """Empty slots (pos -1) and slots past pos are masked; a cache with no
    valid slot gives zeros, as the reference's l = 0 does."""
    K, G, Dh = 2, 7, 32
    q, cache, r_spec, t_spec = _kv_case(bits, B, S, K, G, Dh, n_filled, seed=bits + S)
    ref = np.asarray(jax.jit(lambda q, c: rattn.decode_attention(q, c, pos, kvq=r_spec))(
        jnp.asarray(q), cache).astype(jnp.float32))
    out = tka.decode_attention_packed(_t(q), _port_cache(cache), pos, t_spec)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, K * G, Dh)
    gap = np.abs(out.float().numpy() - ref).max(-1)
    assert (gap <= ATT_TOL * np.abs(ref).max(-1)).all(), gap.max()
    if n_filled == 0 or pos < 0:
        assert not out.float().abs().any()


@pytest.mark.parametrize("cap,window", [(5.0, 0), (30.0, 0), (0.0, 7), (5.0, 7)])
@pytest.mark.parametrize("bits", [4, 8])
def test_decode_attention_packed_plain_takes_cap_and_window(bits, cap, window):
    """A logit soft-cap and a sliding window on a packed cache: the
    reference's decode_attention within the same tolerance."""
    B, S, K, G, Dh, pos = 2, 24, 2, 7, 32, 20
    q, cache, r_spec, t_spec = _kv_case(bits, B, S, K, G, Dh, 22, seed=bits + int(cap) + window)
    ref = np.asarray(jax.jit(lambda q, c: rattn.decode_attention(
        q, c, pos, cap=cap, window=window, kvq=r_spec))(jnp.asarray(q), cache)
        .astype(jnp.float32))
    out = tka.decode_attention_packed(_t(q), _port_cache(cache), pos, t_spec, cap=cap,
                                      window=window)
    gap = np.abs(out.float().numpy() - ref).max(-1)
    assert (gap <= ATT_TOL * np.abs(ref).max(-1)).all(), gap.max()


def test_decode_attention_routes_packed_caches_through_the_fused_call(monkeypatch):
    """models.attention.decode_attention reads a packed cache, soft-capped
    or not, through decode_attention_packed (one call a layer); a bf16 cache
    keeps its own path."""
    calls = []
    real = tka.decode_attention_packed

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tka, "decode_attention_packed", spy)
    q, cache, _, t_spec = _kv_case(4, 2, 9, 2, 2, 32, 9, seed=1)
    c = _port_cache(cache)
    out = tattn.decode_attention(_t(q), c, 8, kvq=t_spec)
    assert len(calls) == 1
    capped = tattn.decode_attention(_t(q), c, 8, cap=30.0, kvq=t_spec)
    assert len(calls) == 2 and capped.shape == out.shape
    dense = {"k": torch.zeros(2, 9, 2, 32, dtype=torch.bfloat16),
             "v": torch.zeros(2, 9, 2, 32, dtype=torch.bfloat16), "pos": c["pos"]}
    tattn.decode_attention(_t(q), dense, 8)
    assert len(calls) == 2


def test_decode_attention_packed_refuses_what_it_does_not_take():
    """The kernel's wrapper refuses a window before it looks at the
    device; neither route takes a bf16 cache, other bits or a q that does
    not fit the cache."""
    q, cache, _, spec = _kv_case(4, 1, 5, 2, 2, 32, 5, seed=2)
    qt, c = _t(q), _port_cache(cache)
    with pytest.raises(ValueError, match="window"):
        tka.decode_attention_packed_cuda(qt, c, 4, spec, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        tka.decode_attention_packed_cuda(qt, c, 4, spec, cap=50.0)
    dense = {"k": torch.zeros(1, 5, 2, 32), "v": torch.zeros(1, 5, 2, 32), "pos": c["pos"]}
    with pytest.raises(ValueError, match="bf16 one"):
        tka.decode_attention_packed(qt, dense, 4, spec)
    with pytest.raises(ValueError, match="bf16 one"):
        tka.decode_attention_packed(qt, c, 4, None)
    for bits in (2, 3, 16):
        with pytest.raises(ValueError, match="kv4 or kv8"):
            tka.decode_attention_packed(qt, c, 4, spec._replace(bits=bits))
    with pytest.raises(ValueError, match="does not fit"):
        tka.decode_attention_packed(qt[:, :, :24], c, 4, spec)


@functools.lru_cache(maxsize=None)
def _ref_greedy(name, kv, S, N):
    from repro.configs.registry import get_arch as r_get_arch

    rcfg = r_get_arch(name).with_kv_quant(kv)
    params = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    prompts = np.random.RandomState(4).randint(0, rcfg.vocab_size, (2, S)).astype(np.int32)
    logits, caches = jax.jit(lambda p, t: rlm.prefill(p, t, rcfg, cache_len=S + N))(
        params, jnp.asarray(prompts))
    ds = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, t, c, pos, rcfg))
    toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for t in range(1, N):
        logits, caches = ds(params, toks[-1], caches, jnp.int32(S + t - 1))
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return params, prompts, np.stack([np.asarray(t) for t in toks], 1)


@pytest.mark.parametrize("kv", [4, 8])
def test_engine_greedy_tokens_at_kv4_kv8(kv, monkeypatch):
    """The whole slice at small size: the port's Engine over the
    reference's weights at a packed cache gives the reference's greedy
    tokens, reading the cache through one fused-attention call a layer and
    decode step."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import Engine

    name, S, N = "tiny-160k", 12, 8
    params, prompts, ref = _ref_greedy(name, kv, S, N)
    cfg = get_arch(name).with_kv_quant(kv)
    calls = []
    real = tka.decode_attention_packed
    monkeypatch.setattr(tka, "decode_attention_packed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ported = interop.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    toks = Engine(ported, cfg, max_seq_len=S + N, device="cpu").generate(prompts, N)
    np.testing.assert_array_equal(toks.numpy(), ref)
    assert len(calls) == cfg.n_layers * (N - 1)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built with nvcc and run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_pack_cuda_bit_exact(bits, dtype):
    _need_cuda()
    for block in (16, 32, 64, 128, 1024):
        for rows, transposed in ((37, False), (37, True), (64, True)):
            cols = block * 3
            rs = np.random.RandomState(bits + block + rows)
            w = torch.tensor((rs.randn(rows, cols) * rs.lognormal(0, 1.5, (rows, 1)))
                             .astype(np.float32), device="cuda")
            for xdt in (torch.bfloat16, torch.float32):
                x = w.to(xdt)
                stored = x.T.contiguous() if transposed else x
                cb = make_codebook(dtype, bits, tensor=x.float())
                kp, ks = tquant.quantize_pack_cuda(stored, cb, bits=bits, block_size=block,
                                                   transposed=transposed)
                pp, ps = tquant.quantize_pack_plain(stored, cb, bits=bits, block_size=block,
                                                    transposed=transposed)
                torch.cuda.synchronize()
                assert _bits_equal(kp, pp) and _bits_equal(ks, ps), (block, rows, transposed)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,B,S,n_filled,pos",
                         ATT_CASES + [(b, 4, 288, 260, 250) for b in (4, 8)]
                         + [(4, 1, 16384, 16000, 15990)])
@pytest.mark.parametrize("K,G,Dh", [(2, 7, 32), (4, 7, 128), (4, 1, 32), (2, 4, 64)])
@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_decode_attention_packed_cuda_matches_plain(bits, B, S, n_filled, pos, K, G, Dh, cap):
    _need_cuda()
    q, cache, _, spec = _kv_case(bits, B, S, K, G, Dh, n_filled, seed=S + K)
    c = {k: v.cuda() for k, v in _port_cache(cache).items()}
    before = tka.decode_attention_packed_cuda.launches
    out = tka.decode_attention_packed_cuda(_t(q).cuda(), c, pos, spec, cap=cap).float()
    plain = tka.decode_attention_packed_plain(_t(q).cuda(), c, pos, spec, cap=cap).float()
    torch.cuda.synchronize()
    assert tka.decode_attention_packed_cuda.launches == before + 1
    gap = (out - plain).abs().amax(-1)
    assert bool((gap <= ATT_TOL * plain.abs().amax(-1)).all()), float(gap.max())
