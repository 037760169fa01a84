"""The route of a packed KV cache's decode read (``kernels/kv_attention``):
the rule ``fused_takes`` that decides, from shapes alone, whether the fused
kernel (``csrc/kv_decode_attention.cu``) takes a call, and the routed read
(``decode_attention_packed_routed``: the KV dequant, then the models'
partials) that serves the shapes it does not take.

* the rule's table: head dims 56 (tiny-10m) and 120 (h2o-danube-3-4b), 9
  query heads a KV head and scale blocks that split a word route to the
  dequant; Qwen2-7B at 288, 4096 and 32768 slots and the tiny ladder's
  other models keep the kernel; at Qwen2-7B's heads the largest cache the
  kernel's shared memory holds stays on it and one slot more routes;
* the rule's constants and layout are the kernel source's;
* on the CPU the routed read is the plain version's computation, bit for
  bit, over slots and pages, with idle rows exactly 0, and the dispatcher
  takes it only for CUDA tensors;
* the KV dequant's one-launch entry (``dequant_kv``) refuses what its
  kernel does not take.
The on-card cases are in ``tests/test_torch_on_card.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.tiny import TINY_FAMILY
from repro_torch.kernels import kv_attention as tka
from repro_torch.kernels import kv_dequant as tkv

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "kv_decode_attention.cu"


def _spec(bits, block=64):
    return tkv.KVQuantSpec(bits=bits, block_size=block, dtype_name="float")


# (B, H, Dh, S, bits, block, feat): calls the kernel refuses
ROUTED = [
    (1, 8, 56, 64, 4, 64, 448),        # tiny-10m: head dim 56
    (8, 8, 56, 576, 8, 64, 448),
    (1, 32, 120, 288, 4, 64, 960),     # h2o-danube-3-4b: head dim 120
    (4, 18, 64, 288, 4, 64, 128),      # 9 query heads a KV head
    (2, 4, 32, 100, 4, 4, 64),         # blocks of 4 codes split a kv4 word of 8
    (2, 4, 32, 100, 8, 2, 64),         # blocks of 2 split a kv8 word of 4
    (1, 28, 128, 40960, 4, 64, 512),   # Qwen2-7B's heads past the shared memory
    (1, 28, 128, 39809, 4, 64, 512),
    (1, 28, 128, 39681, 8, 64, 512),
]


@pytest.mark.parametrize("B,H,Dh,S,bits,block,feat", ROUTED)
def test_rule_routes_the_shapes_the_kernel_refuses(B, H, Dh, S, bits, block, feat):
    spec = _spec(bits, block)
    assert not tka.fused_takes(B, H, Dh, S, spec, feat)
    assert tka.fused_refusal(B, H, Dh, S, spec, feat).startswith("decode_attention_packed_cuda")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("S", [1, 288, 4096, 32768])
def test_rule_keeps_qwen2_7b_on_the_kernel(S, bits):
    cfg = get_arch("qwen2-7b")
    feat = cfg.n_kv_heads * cfg.head_dim
    for B in (1, 4, 8):
        assert tka.fused_takes(B, cfg.n_heads, cfg.head_dim, S, _spec(bits, cfg.kv_block_size),
                               feat)


@pytest.mark.parametrize("name", sorted(TINY_FAMILY))
def test_rule_over_the_tiny_ladder(name):
    """Only tiny-10m (head dim 448 / 8 = 56) leaves the kernel."""
    cfg = TINY_FAMILY[name]
    feat = cfg.n_kv_heads * cfg.head_dim
    for bits in (4, 8):
        takes = tka.fused_takes(8, cfg.n_heads, cfg.head_dim, 576,
                                _spec(bits, cfg.kv_block_size), feat)
        assert takes == (name != "tiny-10m"), (name, bits)


@pytest.mark.parametrize("bits,largest", [(4, 39808), (8, 39680)])
def test_rule_edge_at_qwen2_7b_heads(bits, largest):
    """G = 7, Dh = 128, blocks of 64 (2 a head, so 2 scale words a slot).
    At kv4, 39,808 slots give each of the 8 CTAs 4,976 (whole 16-slot
    tiles), whose f32 scores and bf16 p with the fixed buffers and a round
    of 16 slots fill 58,024 words, 232,096 bytes <= 232,448; 39,809 slots
    round up to 4,992 a CTA and 232,768 bytes.  At kv8 the K/V stage of a
    round is twice as wide and the edge falls 128 slots earlier."""
    spec = _spec(bits)
    assert tka.fused_takes(1, 28, 128, largest, spec, 512)
    assert not tka.fused_takes(1, 28, 128, largest + 1, spec, 512)
    assert "232768" in tka.fused_refusal(1, 28, 128, 39809, _spec(4), 512)


def test_rule_takes_no_window_and_no_grid_past_the_kernels():
    spec = _spec(4)
    assert "window" in tka.fused_refusal(1, 8, 64, 64, spec, 128, window=16)
    assert not tka.fused_takes(65536, 8, 64, 64, spec, 128)
    assert tka.fused_takes(65535, 8, 64, 64, spec, 128)


def test_rule_constants_and_layout_match_kernel_source():
    """MAX_SMEM, CLUSTER, WARPS and MAX_G are the kernel's constants, and
    the rule's layout is its make_layout and cap loop, term for term."""
    src = SRC.read_text()
    for name in ("MAX_SMEM", "CLUSTER", "WARPS", "MAX_G"):
        assert f"constexpr int {name} = {getattr(tka, name)};" in src, name
    for line in ("L.tpc = ((S + CLUSTER - 1) / CLUSTER + 15) / 16 * 16;",
                 "L.tpcp = L.tpc + 4;", "L.tpc2 = L.tpc + 8;",
                 "const int red = WARPS * MAX_G * dh;",
                 "const int stage = cap * (wph + sw);",
                 "L.k_words = ((stage > red ? stage : red) + 3) / 4 * 4;",
                 "L.v_words = (stage + 3) / 4 * 4;", "L.o_m = 256;",
                 "L.o_sc = L.o_pvc + MAX_G * dh;", "L.o_p = L.o_sc + G * L.tpcp;",
                 "L.o_k = (L.o_p + (G * L.tpc2 + 1) / 2 + 3) / 4 * 4;",
                 "a.sw = (nbh + 2) / 2;",
                 "while (a.cap > 16 && make_layout(a.S, a.G, DH, Sh::WPH, a.sw, a.cap).words "
                 "* 4 > MAX_SMEM)",
                 "case 4128:", "case 8032:", "B > 65535 || K > 65535", "bs % (32 / bits)"):
        assert line in src, line


# ---------------------------------------------------------------------------
# the routed read on the CPU
# ---------------------------------------------------------------------------

def _cache(bits, B, S, K, Dh, seed, block=64):
    """A packed cache of rows whose own lengths leave empty slots, q, and
    [B] positions with rows 1 and 3 idle (where there are)."""
    rs = np.random.RandomState(seed)
    spec = _spec(bits, block)
    feat = K * Dh
    cache = {}
    for name in ("k", "v"):
        x = torch.tensor(rs.randn(B, S, feat) * rs.lognormal(0, 0.5, (B, S, 1)),
                         dtype=torch.bfloat16)
        cache[f"{name}_packed"], cache[f"{name}_scales"] = tkv.encode_rows(x, spec)
    lens = rs.randint(1, S + 1, B)
    ar = np.arange(S)
    cache["pos"] = torch.tensor(np.stack([np.where(ar < n, ar, -1) for n in lens]),
                                dtype=torch.int32)
    pos = torch.tensor(lens - 1, dtype=torch.int32)
    pos[[1, 3][: B - 2]] = -1
    return cache, pos, spec


def _paged(cache, ps, seed):
    """The cache's rows in pages of ps under a shuffled page map, page 0
    the empty trash page and two spare pages."""
    B, S = cache["pos"].shape
    P = S // ps
    n_pages = B * P + 3
    ids = torch.tensor(np.random.RandomState(seed).permutation(n_pages - 1)[: B * P] + 1,
                       dtype=torch.int32)
    page_map = ids.reshape(B, P).contiguous()
    out = {}
    for key, leaf in cache.items():
        pages = torch.zeros((n_pages, ps) + tuple(leaf.shape[2:]), dtype=leaf.dtype)
        if key == "pos":
            pages.fill_(-1)
        pages[page_map.reshape(-1).long()] = leaf.reshape((B * P, ps) + tuple(leaf.shape[2:]))
        out[key] = pages
    return out, page_map


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


# (bits, K, G, Dh, block): tiny-10m's heads, 9 query heads a KV head, a
# block that splits a word
ROUTED_READS = [(4, 2, 1, 56, 64), (8, 2, 1, 56, 64), (4, 1, 9, 64, 64), (4, 2, 2, 32, 4)]


@pytest.mark.parametrize("bits,K,G,Dh,block", ROUTED_READS)
@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_routed_read_is_the_plain_version_on_cpu(bits, K, G, Dh, block, cap):
    """Slot rows and the same rows in pages of 8 through a shuffled map:
    the routed read equals the plain version bit for bit, idle rows are
    exactly 0, and pages give the rows' result."""
    B, S = 5, 40
    cache, pos, spec = _cache(bits, B, S, K, Dh, seed=bits * 10 + G + Dh, block=block)
    q = torch.tensor(np.random.RandomState(G).randn(B, K * G, Dh) * 2, dtype=torch.bfloat16)
    assert not tka.fused_takes(B, K * G, Dh, S, spec, K * Dh)
    routed = tka.decode_attention_packed_routed(q, cache, pos, spec, cap=cap)
    plain = tka.decode_attention_packed_plain(q, cache, pos, spec, cap=cap)
    assert routed.dtype == torch.bfloat16 and tuple(routed.shape) == (B, K * G, Dh)
    assert _bits_equal(routed, plain)
    assert not routed[[1, 3]].float().abs().any() and routed[0].float().abs().any()
    paged, page_map = _paged(cache, 8, seed=bits + G)
    kw = dict(cap=cap, page_map=page_map, page_size=8)
    routed_p = tka.decode_attention_packed_routed(q, paged, pos, spec, **kw)
    assert _bits_equal(routed_p, tka.decode_attention_packed_plain(q, paged, pos, spec, **kw))
    assert _bits_equal(routed_p, routed)
    assert _bits_equal(tka.decode_attention_packed(q, paged, pos, spec, **kw), routed)


def test_dequant_kv_plain_reads_rows_and_pages_alike():
    """A layer's K and V through the page map equal the rows' K and V."""
    cache, _, spec = _cache(4, 3, 24, 2, 56, seed=3)
    k, v = tkv.dequant_kv(cache, spec, 112)
    assert tuple(k.shape) == (3, 24, 112) and k.dtype == torch.bfloat16
    assert _bits_equal(k, tkv.dequant_rows_ref(cache["k_packed"], cache["k_scales"], spec, 112))
    assert _bits_equal(v, tkv.dequant_rows_ref(cache["v_packed"], cache["v_scales"], spec, 112))
    paged, page_map = _paged(cache, 8, seed=4)
    kp, vp = tkv.dequant_kv(paged, spec, 112, page_map)
    assert _bits_equal(kp, k) and _bits_equal(vp, v)
    assert _bits_equal(tkv.dequant_pages(paged["k_packed"], paged["k_scales"], page_map, spec,
                                         112), k)


def test_dequant_kv_cuda_refuses_what_its_kernel_does_not_take():
    cache, _, spec = _cache(4, 4, 16, 2, 32, seed=5)
    pair = (cache["k_packed"], cache["k_scales"])
    with pytest.raises(ValueError, match="one CUDA device"):
        tkv.dequant_kv_cuda([pair], spec, 64)
    with pytest.raises(ValueError, match="one or two leaves"):
        tkv.dequant_kv_cuda([pair] * 3, spec, 64)
    with pytest.raises(TypeError, match="int32 packed words"):
        tkv.dequant_kv_cuda([(pair[0].float(), pair[1])], spec, 64)
    with pytest.raises(ValueError, match="do not fit"):
        tkv.dequant_kv_cuda([pair], spec, 128)
    with pytest.raises(ValueError, match="do not fit"):
        tkv.dequant_kv_cuda([pair, (pair[0][:1], pair[1][:1])], spec, 64)
