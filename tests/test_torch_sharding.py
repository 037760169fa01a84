"""The port's sharding policy (``repro_torch.models.sharding``) against the
reference's (``repro.models.sharding``), in-process on duck-typed meshes.

Mirrors ``tests/test_distributed.py:27-54`` (head padding, a no-mesh
sharder as a no-op) and holds the placements to the reference's leaf for
leaf: ``param_spec_tree`` (``_leaf_spec``, ``_qt_spec``) and
``cache_spec_tree`` (slot and paged pools) on tiny-650k, dense and 4-bit,
and on Qwen2-7B's config at ``reduced()``, at mesh shapes 1x2, 2x2 and 2x4.
The reference's Sharder runs on a mesh object that has only axis names and
sizes: the test sets ``_ns`` on the instance to return the spec tuple (the
reference's module is not edited), as ``test_head_padding_policy`` sets
attributes.  Also ``decode_plan``, ``pad_cache_len``, ``seq_shard_plan``,
the padding of q heads inside their KV groups, and
``check_decode_capability``'s refusals (a quantile KV codebook, a feature
row that cannot hold whole code words).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import sharding as rsh  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402

MESHES = [(1, 2), (2, 2), (2, 4)]
TREES = [("tiny-650k", False), ("tiny-650k", True), ("qwen2-7b", False), ("qwen2-7b", True)]
QT_FIELDS = ("packed", "scales", "means", "codebook", "outlier_vals", "outlier_idx")


class RefMesh:
    """The reference's view of a mesh: axis names, sizes, size."""

    def __init__(self, d, m):
        self.axis_names = ("data", "model")
        self.shape = {"data": d, "model": m}
        self.size = d * m


class PortMesh:
    """The port's view: ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``."""

    def __init__(self, d, m):
        self.mesh_dim_names = ("data", "model")
        self.shape = (d, m)


def _cfg(name):
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    if name == "qwen2-7b":
        rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
    return rcfg, tcfg


def _sharders(rcfg, tcfg, d, m, **kw):
    r = rsh.Sharder(RefMesh(d, m), rcfg, **kw)
    r._ns = lambda *spec: tuple(spec)
    return r, tsh.Sharder(PortMesh(d, m), tcfg, **kw)


@functools.lru_cache(maxsize=None)
def _trees(name, quantized):
    """(reference tree, port tree): the reference's init carried across."""
    rcfg, _ = _cfg(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    if quantized:
        raw = r_quantize_params(raw, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg)
    return raw, interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")


def _leaves(tree, prefix=""):
    """{path: spec} of a spec tree, a QuantizedTensor's fields as leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], dict)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, QuantizedTensor) or type(tree).__name__ == "QuantizedTensor":
        return {f"{prefix}.{f}": getattr(tree, f) for f in QT_FIELDS}
    return {prefix: tree}


# -- tests/test_distributed.py:27-54 ------------------------------------------

def test_head_padding_policy():
    s = tsh.Sharder.__new__(tsh.Sharder)
    s.mesh = PortMesh(2, 4)
    s.cfg = get_arch("deepseek-coder-33b")
    s.tp_size = 4
    s.replicate = False
    assert s.head_pad() == 56  # 56 % 4 == 0 already at tp=4
    s.tp_size = 16
    assert s.head_pad() == 64  # 56 -> 64 (divisible by 16 and kv=8)
    s.cfg = get_arch("qwen2-7b")
    assert s.head_pad() == 32  # 28 -> 32 (kv=4, tp=16)


def test_no_mesh_sharder_is_noop():
    cfg = get_arch("tiny-160k")
    s = tsh.Sharder(None, cfg)
    x = torch.ones((2, 3, 4))
    assert s.constrain(x, "residual") is x
    assert s.constrain.gather(x, "heads", x.shape) is x
    assert s.decode_attn_fn(4) is blocks.local_decode_attn
    params = lm.init_params(cfg, device="cpu")
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    assert s.shard_params(params) is params and s.shard_caches(caches, 2) is caches
    assert s.pad_cache_len(13) == 13 and s.seq_shard_plan(2, 13) == {}
    assert s.local_row(caches, 1, 2) == (1, caches)
    assert s.head_pad() == cfg.n_heads and s.param_spec_tree(params)["embed"] is None


# -- placements -----------------------------------------------------------------

@pytest.mark.parametrize("d,m", MESHES)
@pytest.mark.parametrize("name,quantized", TREES)
def test_param_spec_tree_equals_reference(name, quantized, d, m):
    rcfg, tcfg = _cfg(name)
    raw, port = _trees(name, quantized)
    r, t = _sharders(rcfg, tcfg, d, m, replicate_params_below=0)
    ref, got = _leaves(r.param_spec_tree(raw)), _leaves(t.param_spec_tree(port))
    assert ref.keys() == got.keys()
    assert got == ref
    if quantized:   # every 2-D weight is column-parallel somewhere
        assert any(v and "model" in v for k, v in got.items() if k.endswith(".packed"))


@pytest.mark.parametrize("name,quantized", TREES[:2])
def test_replicated_sharder_places_nothing(name, quantized):
    """A model under the replication threshold: every leaf whole."""
    rcfg, tcfg = _cfg(name)
    raw, port = _trees(name, quantized)
    r, t = _sharders(rcfg, tcfg, 2, 2)
    assert t.replicate and r.replicate
    got = _leaves(t.param_spec_tree(port))
    assert got == _leaves(r.param_spec_tree(raw))
    assert all(v in ((), None) or not any(v) for v in got.values())


@pytest.mark.parametrize("d,m", MESHES)
@pytest.mark.parametrize("kv", [16, 4])
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_spec_tree_equals_reference(d, m, kv, batch, paged):
    rcfg, tcfg = _cfg("tiny-650k")
    if kv < 16:
        rcfg, tcfg = rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)
    r, t = _sharders(rcfg, tcfg, d, m, replicate_params_below=0)
    rows, length = (9, 16) if paged else (batch, 24)   # pages of 16, or slots
    rc = rlm.init_caches(rcfg, rows, length, per_slot=True)
    tc = lm.init_caches(tcfg, rows, length, per_slot=True, device="cpu")
    ref = _leaves(r.cache_spec_tree(rc, batch, paged=paged))
    assert _leaves(t.cache_spec_tree(tc, batch, paged=paged)) == ref
    # the shared-position layout of a prefill's cache
    rc1 = rlm.init_caches(rcfg, batch, length)
    tc1 = lm.init_caches(tcfg, batch, length, device="cpu")
    assert _leaves(t.cache_spec_tree(tc1, batch)) == _leaves(r.cache_spec_tree(rc1, batch))


@pytest.mark.parametrize("d,m", MESHES + [(4, 2), (1, 1)])
def test_decode_plans_equal_reference(d, m):
    rcfg, tcfg = _cfg("tiny-650k")
    for window in (0, 5, 6, 12):
        rc = dataclasses.replace(rcfg, sliding_window=window)
        tc = dataclasses.replace(tcfg, sliding_window=window)
        r, t = _sharders(rc, tc, d, m, replicate_params_below=0)
        for batch in (1, 2, 3, 4, 8):
            assert t.decode_plan(batch) == r.decode_plan(batch)
            for cache_len in (7, 16, 24, 30):
                assert t.seq_shard_plan(batch, cache_len) == r.seq_shard_plan(batch,
                                                                              cache_len)
        for n in (1, 13, 24, 30):
            assert t.pad_cache_len(n) == r.pad_cache_len(n)
        assert t.head_pad() == r.head_pad()


@pytest.mark.parametrize("H,K,q_pad", [(6, 2, 8), (28, 4, 32), (4, 4, 4), (3, 1, 4)])
def test_q_head_padding_is_exact(H, K, q_pad):
    """Zero q heads appended inside each KV group attend and are sliced off:
    the real heads' output is the unpadded read's.  The values lie on a
    grid of halves in [-1, 1], where every product and sum of the two
    attention GEMMs is exact in f32: the check is then bit for bit whatever
    order a CPU BLAS sums in at either head count (with randn values it
    failed once in a loaded parallel run and never alone)."""
    g = torch.Generator().manual_seed(H * 100 + K)

    def grid(shape):
        return (torch.randint(-2, 3, shape, generator=g) / 2).to(torch.bfloat16)

    q, k, v = grid((2, 9, H, 8)), grid((2, 9, K, 8)), grid((2, 9, K, 8))
    want = blocks.attend_seq(q, k, v, window=0, cap=0.0)
    got = blocks.attend_seq(q, k, v, window=0, cap=0.0, q_pad=q_pad)
    assert torch.equal(got, want)


# -- check_decode_capability ------------------------------------------------------

def _ref_refusal(rcfg, r):
    try:
        rsh.check_decode_capability(rcfg, r, caller="the test")
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["quantile", "odd_row", "kv4", "kv8", "kv16"])
def test_check_decode_capability_equals_reference(case):
    rcfg, tcfg = _cfg("tiny-650k")
    if case == "quantile":
        rcfg = dataclasses.replace(rcfg, kv_bits=4, kv_dtype="quantile")
        tcfg = dataclasses.replace(tcfg, kv_bits=4, kv_dtype="quantile")
    elif case == "odd_row":   # 2 x 3 features: no whole words of 8 codes
        over = dict(n_heads=2, n_kv_heads=2, head_dim=3, d_model=6)
        rcfg = dataclasses.replace(rcfg.with_kv_quant(4), **over)
        tcfg = dataclasses.replace(tcfg.with_kv_quant(4), **over)
    elif case != "kv16":
        bits = int(case[2:])
        rcfg, tcfg = rcfg.with_kv_quant(bits), tcfg.with_kv_quant(bits)
    r = rsh.Sharder(RefMesh(1, 2), rcfg, replicate_params_below=0)
    t = tsh.Sharder(PortMesh(1, 2), tcfg, replicate_params_below=0)
    ref = _ref_refusal(rcfg, r)
    assert (ref is None) == (case in ("kv4", "kv8", "kv16")), ref
    if ref is None:
        tsh.check_decode_capability(tcfg, t, caller="the test")
        return
    with pytest.raises(ValueError, match="the test") as e:
        tsh.check_decode_capability(tcfg, t, caller="the test")
    assert ("quantile" in str(e.value)) == ("quantile" in ref)
    assert ("whole" in str(e.value) or "words" in str(e.value)) == (case == "odd_row")


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "mamba2-130m", "seamless-m4t-large-v2"])
def test_mesh_refuses_what_waits_for_a11_2(name):
    """Nothing waits for A11.2 any more: a mixture-of-experts, an SSM
    decoder and the encoder-decoder each get a Sharder, which places its
    tree: the expert stacks cut on E, the conv's channels over "model", the
    encoder-decoder's projections column- or row-parallel and its
    vocabulary (256,206 rows, even) over "model"."""
    cfg = get_arch(name)
    s = tsh.Sharder(PortMesh(1, 2), cfg, replicate_params_below=0)
    if cfg.encoder_decoder:
        from repro_torch.models import seq2seq

        specs = _leaves(s.param_spec_tree(seq2seq.init_params(cfg, device="meta")))
        assert specs["/enc_stack/mixer/wq/w"] == (None, "data", "model")
        assert specs["/dec_stack/cross_attn/wo/w"] == (None, "model", "data")
        assert specs["/frame_proj/w"] == ("data", "model")
        assert specs["/embed"] == specs["/lm_head"] == ("model", "data")
        return
    specs = _leaves(s.param_spec_tree(lm.init_params(cfg, device="meta")))
    if cfg.n_experts:
        assert specs["/stack/0/ffn/w_gate"] == (None, "model", "data", None)
        assert specs["/stack/0/ffn/router"] == ()
    else:
        assert specs["/stack/0/mixer/conv_w"] == (None, None, "model")


def test_make_mesh_names_the_world(tmp_path):
    """A world of one rank (gloo, a file:// rendezvous): make_mesh gives the
    ("data", "model") mesh of its size and refuses another, naming the
    world's size; a Sharder on it makes a group for every set of axes."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_mesh

    with pytest.raises(ValueError, match="cuda or cpu"):
        init_world("meta", rank=0, world=1, init_file=str(tmp_path / "r"))
    assert init_world("cpu", rank=0, world=1, init_file=str(tmp_path / "r")) == torch.device("cpu")
    try:
        with pytest.raises(ValueError, match="world has 1"):
            make_mesh(1, 2, "cpu")
        mesh = make_mesh(1, 1, "cpu")
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        s = tsh.Sharder(mesh, get_arch("tiny-650k"), replicate_params_below=0)
        assert s.coord(("data", "model")) == (0, 1) and s.coord(None) == (0, 1)
        for axes in ("data", "model", ("data", "model")):
            assert dist.get_world_size(s.group(axes)) == 1
    finally:
        dist.destroy_process_group()
