"""The port's mixture-of-experts decoders (``models/moe.py`` and the MoE
path through blocks, lm, quantize, the Engine and the Server) against the
JAX package, on the CPU.

Weights come from the reference's ``init_params(PRNGKey(0))`` (or
``init_moe``) at ``reduced()`` shapes (moonshot-v1-16b-a3b and
phi3.5-moe-42b-a6.6b: 2 layers, d 64, 4 experts of width 32, top-2) and
are carried across with ``interop.params_from_reference``; inputs are
numpy draws from fixed seeds.  The reference is compiled without XLA's
excess precision, as in ``tests/test_torch_model.py``.  The bars:

* configs field for field, ``count_params`` at full size with and without
  ``active_only`` the reference's;
* ``moe_ffn`` (unmasked with one dispatch group and with 16, T = 256, and
  masked with padding): the same expert choices, the outputs within one
  bf16 ulp of the output's largest value (the expert products sum in f32
  in another order than XLA's dot; the observed gap is 0), the aux loss
  within 1e-5 relative (f32 means in another order);
* a bucket-padded, masked prefill's rows equal to the exact-length
  unmasked ones bit for bit, in the port and against the reference's
  masked call;
* quantized trees bit for bit (the expert stacks' words, scales and
  codebooks), a stack encoded a layer at a time equal to the whole-stack
  encode, layer and expert views of the QT without copies;
  ``quantizable_units`` names, kinds, shapes and proxy outlier indices;
* the expert route's plain versions: the expert-batched GEMV's
  (``qmatmul.qmatmul_experts_plain``) and the fused MoE path's products
  within one bf16 ulp of ``_materialize``'s;
* backbone logits within 0.08 of the reference's (the decode-consistency
  bar of tests/test_decode_consistency.py) at 4 bits, fused and
  dequant_einsum;
* the Engine's greedy tokens the reference's (a near-tie within 0.08 of
  the reference's maximum allowed), and the Server (bucketed prefills with
  the router pad mask) equal to the per-request Engine and to the
  reference's Server, as ``tests/test_serving.py``'s MoE case; chunked
  prefill refused with the reference's error.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.quantize import quantizable_units as r_units  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import Server as RServer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.core.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.kernels import qmatmul as qk  # noqa: E402
from repro_torch.models import blocks, lm, moe  # noqa: E402
from repro_torch.models.quantize import (  # noqa: E402
    quantizable_units,
    quantize_params,
    quantize_unit,
)
from repro_torch.serving import Engine, Server  # noqa: E402

torch.set_num_threads(2)

MOE_ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
NO_EXCESS = {"xla_allow_excess_precision": False}
LOGIT_TOL = 0.08                 # tests/test_decode_consistency.py
AUX_REL = 1e-5
BASE = dict(bits=4, dtype="float", block_size=64)
# d 64 at reduced(): the experts' d_ff of 32 holds no 64-block, so the tests
# of the fused path quantize at block 32 (rows of whole blocks)
FUSED_BASE = dict(bits=4, dtype="float", block_size=32)


def _cfgs(name):
    return r_get_arch(name).reduced(), get_arch(name).reduced()


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(reference tree, port tree) from the reference's PRNGKey(0) init."""
    rcfg, _ = _cfgs(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    return raw, interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")


@functools.lru_cache(maxsize=None)
def _moe_weights(name):
    rcfg, _ = _cfgs(name)
    raw = jax.jit(lambda k: rmoe.init_moe(k, rcfg))(jax.random.PRNGKey(1))
    return raw, interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")


def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    t = np.asarray(t)
    return t.view(np.int16) if t.dtype.name == "bfloat16" else t.view(np.int32) \
        if t.dtype == np.uint32 else t


def _x(B, S, D, seed=0):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def _ulp_gap(a, b):
    """max |a - b| and one bf16 ulp of max |a| (2^-7 of it)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()), 2.0**-7 * float(np.abs(a).max())


# -------------------------------------------------------------------------
# configs
# -------------------------------------------------------------------------

@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_configs_and_full_size_counts_equal_reference(name, active_only):
    ref, mine = r_get_arch(name), get_arch(name)
    assert dataclasses.asdict(mine) == {k: v for k, v in dataclasses.asdict(ref).items()
                                        if k != "kv_use_kernel"}
    assert lm.count_params(mine, active_only) == rlm.count_params(ref, active_only)
    assert lm.count_params(mine.reduced(), active_only) == rlm.count_params(ref.reduced(),
                                                                            active_only)
    assert blocks.stack_schedule(mine) == [("attn", "moe")]


# -------------------------------------------------------------------------
# moe_ffn
# -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_moe(name, B, S, n_pad):
    """The reference's moe_ffn (masked where n_pad > 0: the last n_pad
    positions of each row are padding) and its routing."""
    rcfg, _ = _cfgs(name)
    raw, _ = _moe_weights(name)
    x = jnp.asarray(_x(B, S, rcfg.d_model)).astype(jnp.bfloat16)
    pm = None if not n_pad else jnp.arange(S)[None, :].repeat(B, 0) < S - n_pad
    f = jax.jit(lambda p, x, pm: rmoe.moe_ffn(p, x, rcfg, pad_mask=pm))
    y, aux = f.lower(raw, x, pm).compile(compiler_options=NO_EXCESS)(raw, x, pm)
    return np.asarray(y, np.float32), float(aux["moe_aux"])


def _port_moe(name, B, S, n_pad, cfg=None, params=None):
    _, tcfg = _cfgs(name)
    _, tp = _moe_weights(name)
    x = torch.from_numpy(_x(B, S, tcfg.d_model)).to(torch.bfloat16)
    pm = None if not n_pad else (torch.arange(S)[None, :] < S - n_pad).expand(B, S)
    with torch.inference_mode():
        y, aux = moe.moe_ffn(params or tp, x, cfg or tcfg, pm)
    return y.float().numpy(), float(aux["moe_aux"])


@pytest.mark.parametrize("B,S,n_pad", [(2, 24, 0), (1, 256, 0), (2, 32, 9)],
                         ids=["one-group", "16-groups", "masked"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_ffn_matches_reference(name, B, S, n_pad):
    _, tcfg = _cfgs(name)
    assert moe._n_groups(B * S) == (16 if S == 256 else 1)
    ry, raux = _ref_moe(name, B, S, n_pad)
    ty, taux = _port_moe(name, B, S, n_pad)
    gap, ulp = _ulp_gap(ry, ty)
    assert gap <= ulp, (gap, ulp)
    assert abs(taux - raux) <= AUX_REL * abs(raux), (taux, raux)
    if n_pad:   # pads combine nothing
        assert not ty[:, S - n_pad:].any()


def test_routing_matches_reference_and_ties_go_to_the_lower_id():
    """The router's probabilities, gates and expert ids: bf16 logits tie
    often, and the port's stable sort keeps the lower id first as
    jax.lax.top_k does."""
    name = "moonshot-v1-16b-a3b"
    rcfg, tcfg = _cfgs(name)
    raw, tp = _moe_weights(name)
    x = jnp.asarray(_x(2, 24, rcfg.d_model)).astype(jnp.bfloat16)

    @jax.jit
    def ref(p, x):
        from repro.models.layers import linear
        probs = jax.nn.softmax(linear(x, p["router"]).astype(jnp.float32), axis=-1)
        g, e = jax.lax.top_k(probs, rcfg.top_k)
        return probs, g / jnp.sum(g, -1, keepdims=True), e

    rp, rg, re_ = (np.asarray(a) for a in ref(raw, x))
    tpb, tg, te = moe.route(tp, torch.from_numpy(np.array(x.astype(jnp.float32)))
                            .to(torch.bfloat16), tcfg)
    assert np.array_equal(te.numpy(), re_)
    assert np.abs(tpb.numpy() - rp).max() <= 1e-6 and np.abs(tg.numpy() - rg).max() <= 1e-6
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25]])
    _, ids = torch.sort(probs, descending=True, stable=True)
    assert ids[0, :2].tolist() == [0, 1]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_padded_masked_prefill_equals_exact_length(name):
    """A bucket of 32 holding 23 real tokens, masked, keeps and drops what
    the exact 23 tokens unmasked do: rows equal bit for bit, in the port,
    and the reference's masked rows the same within one ulp."""
    _, tcfg = _cfgs(name)
    _, tp = _moe_weights(name)
    L, Sb = 23, 32
    x = torch.from_numpy(_x(1, Sb, tcfg.d_model, seed=3)).to(torch.bfloat16)
    pm = torch.arange(Sb)[None, :] < L
    with torch.inference_mode():
        exact, _ = moe.moe_ffn(tp, x[:, :L], tcfg)
        padded, _ = moe.moe_ffn(tp, x, tcfg, pm)
    assert moe.capacity(L, tcfg) <= moe.capacity(Sb, tcfg)
    assert torch.equal(padded[:, :L], exact)
    rcfg, _ = _cfgs(name)
    raw, _ = _moe_weights(name)
    ry, _ = jax.jit(lambda p, x, m: rmoe.moe_ffn(p, x, rcfg, pad_mask=m))(
        raw, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jnp.asarray(pm.numpy()))
    gap, ulp = _ulp_gap(np.asarray(ry, np.float32)[:, :L], exact.float().numpy())
    assert gap <= ulp


def test_capacity_drops_tokens_as_reference():
    """A capacity factor that drops: the port keeps and drops what the
    reference does (the outputs agree), masked and not."""
    name = "phi3.5-moe-42b-a6.6b"
    rcfg, tcfg = _cfgs(name)
    rsmall = dataclasses.replace(rcfg, capacity_factor=0.25)
    tsmall = dataclasses.replace(tcfg, capacity_factor=0.25)
    raw, tp = _moe_weights(name)
    x = _x(2, 64, rcfg.d_model, seed=5)
    for n_pad in (0, 20):
        pm = None if not n_pad else np.arange(64)[None, :].repeat(2, 0) < 64 - n_pad
        ry, _ = jax.jit(lambda p, x, m: rmoe.moe_ffn(p, x, rsmall, pad_mask=m))(
            raw, jnp.asarray(x).astype(jnp.bfloat16), None if pm is None else jnp.asarray(pm))
        with torch.inference_mode():
            ty, _ = moe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), tsmall,
                                None if pm is None else torch.from_numpy(pm))
        gap, ulp = _ulp_gap(np.asarray(ry, np.float32), ty.float().numpy())
        assert gap <= ulp, (n_pad, gap)
        # some tokens were dropped: their rows are zero in both
        dropped = ~np.asarray(ry, np.float32).any(-1)
        assert dropped.sum() > (n_pad * 2) and np.array_equal(dropped, ~ty.float().numpy().any(-1))


# -------------------------------------------------------------------------
# quantized expert stacks
# -------------------------------------------------------------------------

@pytest.mark.parametrize("pct", [0.0, 0.05])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_units_match_reference(name, pct):
    """Names, kinds ("moe" for the stacks), shapes, n_params and proxy
    outlier index sets (an expert's w_down from its w_up's stds)."""
    rcfg, tcfg = _cfgs(name)
    raw, params = _weights(name)
    ref = r_units(raw, rcfg, RQuantConfig(**BASE, outlier_pct=pct))
    mine = quantizable_units(params, tcfg, QuantConfig(**BASE, outlier_pct=pct))
    assert list(mine) == list(ref)
    assert {u: m["kind"] for u, m in mine.items() if m["kind"] == "moe"} == {
        f"stack/0/ffn/{k}": "moe" for k in moe.MOE_WEIGHTS}
    assert "stack/0/ffn/router" not in mine
    for u, r in ref.items():
        m = mine[u]
        assert (m["kind"], m["n_params"], m["shape"]) == (r["kind"], r["n_params"], r["shape"])
        if r["outlier_idx"] is None:
            assert m["outlier_idx"] is None, u
        else:
            assert np.array_equal(m["outlier_idx"].numpy(), np.asarray(r["outlier_idx"])), u


@pytest.mark.parametrize("base", [BASE, FUSED_BASE], ids=["b64", "b32"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_quantized_tree_bit_exact_to_reference(name, base):
    """Every leaf of the 4-bit tree, the expert stacks' words, scales and
    codebooks included, bit for bit; the router stays the raw f32 weight."""
    rcfg, tcfg = _cfgs(name)
    raw, params = _weights(name)
    rq = jax.jit(lambda p: r_quantize_params(p, RQuantConfig(**base), rcfg))(raw)
    tq = quantize_params(params, QuantConfig(**base), tcfg, device="cpu")
    carried = interop.flatten(interop.params_from_reference(jax.tree.map(np.asarray, rq),
                                                            device="cpu"))
    own = interop.flatten(tq)
    assert set(own) == set(carried)
    for key, a in carried.items():
        assert a.dtype == own[key].dtype and np.array_equal(_bits(a), _bits(own[key])), key
    stack = tq["stack"][0]["ffn"]
    assert stack["router"].dtype == torch.float32
    w = stack["w_down"]
    assert isinstance(w, QuantizedTensor) and w.batch_shape == (tcfg.n_layers, tcfg.n_experts)
    assert w.structured == (base is FUSED_BASE)   # rows of 32: whole blocks of 32 only


def test_layer_at_a_time_encode_equals_whole_stack_and_views_share_storage():
    """An expert stack encoded one layer at a time gives the whole-stack
    encode's words, scales and codebooks bit for bit; a layer's and an
    expert's QT (``select``) are views of the stack's storage."""
    _, tcfg = _cfgs("moonshot-v1-16b-a3b")
    _, params = _weights("moonshot-v1-16b-a3b")
    w = params["stack"][0]["ffn"]["w_down"]                 # [n_p, E, F, D]
    qcfg = QuantConfig(**FUSED_BASE)
    whole = quantize_unit("moe", w, qcfg)
    for i in range(w.shape[0]):
        one = quantize_unit("moe", w[i:i + 1], qcfg)
        for f in ("packed", "scales", "codebook"):
            assert torch.equal(getattr(one, f)[0], getattr(whole, f)[i]), (i, f)
    layer = whole.select(1)
    expert = layer.select(2)
    assert layer.batch_shape == (tcfg.n_experts,) and expert.batch_shape == ()
    assert expert.packed.data_ptr() == whole.packed[1, 2].data_ptr()
    assert expert.scales.data_ptr() == whole.scales[1, 2].data_ptr()
    assert moe.experts_fused_eligible(layer) and not moe.experts_fused_eligible(expert)


# -------------------------------------------------------------------------
# the expert route's plain versions
# -------------------------------------------------------------------------

def _fused_layer(name):
    _, tcfg = _cfgs(name)
    _, params = _weights(name)
    tq = quantize_params(params, QuantConfig(**FUSED_BASE), tcfg, device="cpu")
    return tcfg, blocks.take(tq["stack"][0], 0)["ffn"]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_expert_gemv_plain_equals_materialize(name):
    """qmatmul_experts_plain on [E, 8, K] equals the dense product of
    _materialize's weights within one bf16 ulp (both round the weight to
    bf16 and sum in f32; only the order differs)."""
    tcfg, ffn = _fused_layer(name)
    E = tcfg.n_experts
    for key in moe.MOE_WEIGHTS:
        w = ffn[key]
        K = w.quant_shape[1]
        x = torch.from_numpy(_x(E, qk.GEMV_MAX_M, K, seed=7)).to(torch.bfloat16)
        counts = torch.tensor([0, 1, 8, 3][:E], dtype=torch.int32)
        y = qk.qmatmul_experts(x, w.packed, w.scales, w.codebook, counts, bits=w.bits,
                               block_size=w.block_size)
        dense = moe._materialize(w, torch.bfloat16)           # [E, K, N]
        ref = torch.einsum("emk,ekn->emn", x.float(), dense.float())
        gap, ulp = _ulp_gap(ref.to(torch.bfloat16).float().numpy(), y.float().numpy())
        assert y.shape == (E, qk.GEMV_MAX_M, w.quant_shape[0]) and gap <= ulp, (key, gap)


@pytest.mark.parametrize("decode", [False, True], ids=["per-expert", "batched"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_fused_moe_equals_dequant_einsum(name, decode):
    """moe_ffn through the kernels' plain versions (the batched GEMV at a
    decode of 8 rows, a GEMM an expert otherwise) against the oracle
    (dequant_einsum) on the same QTs: within one bf16 ulp."""
    tcfg, ffn = _fused_layer(name)
    B, S = (8, 1) if decode else (2, 24)
    x = torch.from_numpy(_x(B, S, tcfg.d_model, seed=9)).to(torch.bfloat16)
    with torch.inference_mode():
        fused, _ = moe.moe_ffn(ffn, x, tcfg.with_matmul_mode("fused"), decode=decode)
        oracle, _ = moe.moe_ffn(ffn, x, tcfg.with_matmul_mode("dequant_einsum"), decode=decode)
    gap, ulp = _ulp_gap(oracle.float().numpy(), fused.float().numpy())
    assert gap <= ulp and bool(torch.isfinite(fused).all())


# -------------------------------------------------------------------------
# the model, the Engine and the Server
# -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _quantized(name, mode):
    rcfg, tcfg = _cfgs(name)
    raw, params = _weights(name)
    rq = jax.jit(lambda p: r_quantize_params(p, RQuantConfig(**FUSED_BASE), rcfg))(raw)
    tq = quantize_params(params, QuantConfig(**FUSED_BASE), tcfg, device="cpu")
    return rq, tq, tcfg.with_matmul_mode(mode)


@pytest.mark.parametrize("mode", ["fused", "dequant_einsum"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_backbone_logits_match_reference(name, mode):
    """4-bit weights (block 32): the port's logits through either mode
    within 0.08 of the reference's (which materializes the experts)."""
    rcfg, _ = _cfgs(name)
    rq, tq, tcfg = _quantized(name, mode)
    toks = np.random.RandomState(2).randint(0, rcfg.vocab_size, (2, 24)).astype(np.int32)
    f = jax.jit(lambda p, t: rlm.logits_from_hidden(p, rlm.backbone_seq(p, t, rcfg)[0], rcfg))
    ref = np.asarray(f.lower(rq, jnp.asarray(toks)).compile(compiler_options=NO_EXCESS)(
        rq, jnp.asarray(toks)), np.float32)
    with torch.inference_mode():
        h, _ = lm.backbone_seq(tq, torch.from_numpy(toks).long(), tcfg)
        mine = lm.logits_from_hidden(tq, h, tcfg).float().numpy()
    gap = float(np.abs(ref - mine).max())
    assert gap < LOGIT_TOL, gap


@pytest.mark.parametrize("kv", [16, 4])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_engine_greedy_tokens_match_reference(name, kv):
    """The Engine (prefill, then decode steps with the shared position:
    unmasked routing) on 4-bit weights: each greedy token the reference
    Engine's argmax, teacher-forced, or within 0.08 of its maximum."""
    rcfg, _ = _cfgs(name)
    rq, tq, tcfg = _quantized(name, "fused")
    rcfg, tcfg = rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)
    B, S, N = 2, 12, 10
    prompts = np.random.RandomState(4).randint(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    toks = Engine(tq, tcfg, max_seq_len=S + N, device="cpu").generate(prompts, N).numpy()
    pf = jax.jit(lambda p, x: rlm.prefill(p, x, rcfg, cache_len=S + N))
    ds = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, t, c, pos, rcfg))
    logits, caches = pf.lower(rq, jnp.asarray(prompts)).compile(
        compiler_options=NO_EXCESS)(rq, jnp.asarray(prompts))
    step = ds.lower(rq, jnp.asarray(toks[:, 0]), caches, jnp.int32(S)).compile(
        compiler_options=NO_EXCESS)
    out = [np.asarray(logits, np.float32)]
    for t in range(N - 1):
        logits, caches = step(rq, jnp.asarray(toks[:, t]), caches, jnp.int32(S + t))
        out.append(np.asarray(logits, np.float32))
    ref = np.stack(out)                                          # [N, B, V]
    chosen = np.take_along_axis(ref, toks.T[..., None], -1)[..., 0]
    assert (ref.max(-1) - chosen <= LOGIT_TOL).all(), toks
    assert (toks == ref.argmax(-1).T).mean() > 0.9


def _serve(srv, prompts, budgets, arrivals):
    ids = [srv.submit(p, m, arrival_time=a) for p, m, a in zip(prompts, budgets, arrivals)]
    res = srv.run_until_drained()
    return [list(res[i]) for i in ids]


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "pages"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_server_buckets_with_pad_mask_and_matches_engine(name, paged, monkeypatch):
    """Prompts of 9 to 13 tokens bucket to 16 (the router pad mask passed),
    decoding on a pool whose idle rows are masked out of capacity: every
    request's tokens the per-request Engine's, on slots and on pages."""
    _, params = _weights(name)
    _, tcfg = _cfgs(name)
    rs = np.random.RandomState(8)
    lens, budgets = [9, 10, 11, 12, 13], [6, 4, 8, 5, 7]
    prompts = [rs.randint(0, tcfg.vocab_size, L) for L in lens]
    seen = []
    real = lm.backbone_seq
    monkeypatch.setattr(lm, "backbone_seq", lambda p, t, *a, **k: seen.append(
        (t.shape[1], None if k.get("pad_mask") is None else int(k["pad_mask"].sum())))
        or real(p, t, *a, **k))
    kw = dict(paged=True, page_size=8) if paged else {}
    srv = Server(params, tcfg, num_slots=2, max_seq_len=32, device="cpu", **kw)
    out = _serve(srv, prompts, budgets, [0.5 * i for i in range(5)])
    assert seen == [(16, L) for L in lens]
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        ref = Engine(params, tcfg, max_seq_len=32, device="cpu").generate(p[None], m)
        assert out[i] == ref[0].tolist(), i


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b"])
def test_server_tokens_match_reference_server(name, monkeypatch):
    """tests/test_serving.py's MoE case on the port, on its arch (phi3.5 at
    reduced()): 3 prompts of 10 tokens on 2 slots; the port's Server tokens
    equal the reference Server's (both bucket with the pad mask) and the
    per-request Engine's.  Not held on moonshot-v1 at reduced() on raw
    weights: its router's bf16 logits over 4 experts tie (layer 1, token 6:
    probabilities 0.25817 and 0.25817), and the attention's last-ulp
    differences from XLA's (f32 sums in another order) flip the tie, which
    moves every later token's expert slots; its tokens are held to the
    reference's Engine above, and to its own per-request Engine."""
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=NO_EXCESS))
    raw, params = _weights(name)
    rcfg, tcfg = _cfgs(name)
    B, S, N = 3, 10, 4
    prompts = np.random.RandomState(5).randint(1, rcfg.vocab_size, (B, S)).astype(np.int32)
    rsrv = RServer(raw, rcfg, num_slots=2, max_seq_len=S + N)
    ref = _serve(rsrv, list(prompts), [N] * B, [0.5 * b for b in range(B)])
    mine = _serve(Server(params, tcfg, num_slots=2, max_seq_len=S + N, device="cpu"),
                  list(prompts), [N] * B, [0.5 * b for b in range(B)])
    reng = REngine(raw, rcfg, max_seq_len=S + N)
    for b in range(B):
        eng = Engine(params, tcfg, max_seq_len=S + N, device="cpu").generate(prompts[b:b + 1], N)
        assert mine[b] == eng[0].tolist(), b
        assert list(np.asarray(reng.generate(jnp.asarray(prompts[b:b + 1]), N))[0]) == ref[b]
    assert [[int(t) for t in r] for r in ref] == mine


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_chunked_prefill_refused(name):
    """The reference's refusal: MoE dispatch absorbs chunk boundaries; and
    the chunk path itself refuses a MoE layer."""
    _, params = _weights(name)
    _, tcfg = _cfgs(name)
    with pytest.raises(ValueError, match="prefill_chunk needs a bucketing-safe arch"):
        Server(params, tcfg, num_slots=2, max_seq_len=32, prefill_chunk=8, device="cpu")
    ws = lm.init_caches(tcfg.with_kv_quant(16), 1, 16, device="cpu")
    with pytest.raises(ValueError, match="dense MLPs only"):
        lm.backbone_chunk(params, torch.zeros((1, 8), dtype=torch.long), ws, 0, tcfg)
