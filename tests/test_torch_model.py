"""The port's model and serving slice against the JAX package.

Weights come from ``repro.models.lm.init_params(PRNGKey(0))`` and are
carried across with ``interop.params_from_reference``; quantized trees come
both from the reference carried across and from the port's own
``quantize_params``, and the two are identical leaf by leaf (every model at
4 and 8 bits, tiny-160k also at 3, 5 and 6, where the Engine is held to the
reference's greedy tokens too).

The logit bar is the reference's own decode-consistency tolerance, 0.08
(tests/test_decode_consistency.py): teacher-forced prefill and 8 decode
steps on tiny-160k, tiny-650k and qwen2-7b.reduced() (QKV bias, rope_theta
1e6, untied head) x {bf16, 4-bit, 8-bit float weights} x {kv16, kv8, kv4}.

The reference is compiled with XLA's ``xla_allow_excess_precision`` off, so
every bf16 value is rounded where its code rounds it — the semantics the
port implements and the reference shows when run op by op.  With the
default (on), XLA keeps f32 where a bf16 value is upcast again, and which
roundings it drops depends on fusion: the reference's own compiled and
op-by-op runs then differ by up to 0.48 at kv4 on qwen2-7b.reduced(),
because a one-ulp change in a key flips its 4-bit code.  Quantized
reference trees run as their dequantized dense trees, which the reference
computes identically (checked here for one cell) and which share one
compilation per (model, kv).
"""

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
from repro.models.quantize import dequantize_params as r_dequantize_params  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving import perplexity as r_perplexity  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quantize import dequantize_params, quantize_params  # noqa: E402
from repro_torch.serving import KV_LOGIT_TOL, Engine, kv_oracle_logit_gap, perplexity  # noqa: E402

torch.set_num_threads(2)

LOGIT_TOL = 0.08                 # tests/test_decode_consistency.py
NO_EXCESS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
MODELS = ["tiny-160k", "tiny-650k", "qwen2-7b-reduced"]
PROMPT, STEPS = 8, 8


def _cfgs(name):
    if name == "qwen2-7b-reduced":
        return r_get_arch("qwen2-7b").reduced(), get_arch("qwen2-7b").reduced()
    return r_get_arch(name), get_arch(name)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _raw(name):
    rcfg, _ = _cfgs(name)
    return jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _quantized(name, bits):
    """The reference's tree quantized at `bits` (float, block 64) and the
    dense tree it runs as."""
    rcfg, _ = _cfgs(name)
    q = jax.jit(lambda p: r_quantize_params(
        p, RQuantConfig(bits=bits, dtype="float", block_size=64), rcfg))(_raw(name))
    return q, jax.jit(r_dequantize_params)(q)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """Reference trees {w16, q4, q8} and the dense trees the reference runs."""
    raw = _raw(name)
    trees = {"w16": raw}
    dense = {"w16": raw}
    for bits in (4, 8):
        trees[f"q{bits}"], dense[f"q{bits}"] = _quantized(name, bits)
    return trees, dense


@functools.lru_cache(maxsize=None)
def _port_weights(name, weights):
    """The port's tree: the carried raw tree, quantized by the port."""
    _, tcfg = _cfgs(name)
    trees, _ = _weights(name)
    raw = interop.params_from_reference(_numpy_tree(trees["w16"]), device="cpu")
    if weights == "w16":
        return raw
    bits = int(weights[1:])
    return quantize_params(raw, QuantConfig(bits=bits, dtype="float", block_size=64), tcfg,
                           device="cpu")


def _tokens(name):
    rcfg, _ = _cfgs(name)
    return np.random.RandomState(7).randint(0, rcfg.vocab_size, (2, PROMPT + STEPS)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _ref_fns(name, kv, template="w16"):
    """Reference prefill and decode step compiled without excess precision."""
    rcfg, _ = _cfgs(name)
    c = rcfg.with_kv_quant(kv)
    trees, dense = _weights(name)
    params = dense["w16"] if template == "w16" else trees[template]
    toks = jnp.asarray(_tokens(name))
    cache_len = PROMPT + STEPS
    pf = jax.jit(lambda p, x: rlm.prefill(p, x, c, cache_len=cache_len)).lower(
        params, toks[:, :PROMPT]).compile(compiler_options=NO_EXCESS)
    _, caches = pf(params, toks[:, :PROMPT])
    ds = jax.jit(lambda p, t, ca, pos: rlm.decode_step(p, t, ca, pos, c)).lower(
        params, toks[:, PROMPT], caches, jnp.int32(PROMPT)).compile(compiler_options=NO_EXCESS)
    return pf, ds


def _ref_logits(name, kv, params, template="w16"):
    pf, ds = _ref_fns(name, kv, template)
    toks = jnp.asarray(_tokens(name))
    logits, caches = pf(params, toks[:, :PROMPT])
    out = [np.asarray(logits, np.float32)]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, caches = ds(params, toks[:, t], caches, jnp.int32(t))
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def _port_logits(name, kv, params, matmul_mode=None):
    _, tcfg = _cfgs(name)
    c = tcfg.with_kv_quant(kv)
    if matmul_mode:
        c = c.with_matmul_mode(matmul_mode)
    toks = torch.from_numpy(_tokens(name)).long()
    with torch.inference_mode():
        logits, caches = lm.prefill(params, toks[:, :PROMPT], c, cache_len=PROMPT + STEPS)
        out = [logits.float().numpy()]
        for t in range(PROMPT, PROMPT + STEPS):
            logits, caches = lm.decode_step(params, toks[:, t], caches, t, c)
            out.append(logits.float().numpy())
    return np.stack(out)


# every model at 4 and 8 bits; tiny-160k also at 3, 5 and 6, the widths the
# tensor-core GEMV takes across word boundaries (cpw 10, 6 and 5)
@pytest.mark.parametrize("name,bits", [(n, b) for n in MODELS for b in (4, 8)]
                         + [("tiny-160k", b) for b in (3, 5, 6)])
def test_quantize_params_identical_to_reference(name, bits):
    q_ref, dense_ref = _quantized(name, bits)
    carried = interop.flatten(interop.params_from_reference(_numpy_tree(q_ref), device="cpu"))
    own = interop.flatten(_port_weights(name, f"q{bits}"))
    ref_keys = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(q_ref)}
    assert set(carried) == set(own) == ref_keys
    for key, a in carried.items():
        b = own[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), key
    back = interop.flatten(dequantize_params(_port_weights(name, f"q{bits}")))
    ref_back = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_leaves_with_path(dense_ref)}
    for key, v in back.items():
        np.testing.assert_array_equal(v.numpy(), ref_back[key], err_msg=key)


@pytest.mark.parametrize("kv", [16, 8, 4])
@pytest.mark.parametrize("weights", ["w16", "q4", "q8"])
@pytest.mark.parametrize("name", MODELS)
def test_teacher_forced_logits_match_reference(name, weights, kv):
    _, dense = _weights(name)
    ref = _ref_logits(name, kv, dense[weights])
    port = _port_logits(name, kv, _port_weights(name, weights))
    assert ref.shape == port.shape
    gap = float(np.abs(ref - port).max())
    assert gap < LOGIT_TOL, (name, weights, kv, gap)


def test_reference_quantized_tree_runs_as_its_dense_tree():
    """The substitution the grid makes, checked on one cell: the reference's
    own quantized (fused) path gives the logits of its dequantized tree, and
    the port is within the bar of it."""
    name, kv = "qwen2-7b-reduced", 4
    trees, dense = _weights(name)
    fused = _ref_logits(name, kv, trees["q4"], template="q4")
    np.testing.assert_array_equal(fused, _ref_logits(name, kv, dense["q4"]))
    assert float(np.abs(fused - _port_logits(name, kv, _port_weights(name, "q4"))).max()) \
        < LOGIT_TOL


def test_perplexity_matches_reference():
    name = "tiny-160k"
    rcfg, tcfg = _cfgs(name)
    trees, _ = _weights(name)
    toks = np.random.RandomState(3).randint(0, rcfg.vocab_size, (3, 33)).astype(np.int32)
    ref = r_perplexity(trees["q4"], rcfg, jnp.asarray(toks))
    port = perplexity(_port_weights(name, "q4"), tcfg, toks, device="cpu")
    assert abs(port - ref) / ref < 1e-3, (port, ref)


@functools.lru_cache(maxsize=None)
def _ref_greedy_fns(name, S, N):
    rcfg, _ = _cfgs(name)
    dense = _weights(name)[1]["w16"]
    x = jnp.zeros((3, S), jnp.int32)
    pf = jax.jit(lambda p, t: rlm.prefill(p, t, rcfg, cache_len=S + N)).lower(
        dense, x).compile(compiler_options=NO_EXCESS)
    _, caches = pf(dense, x)
    ds = jax.jit(lambda p, t, ca, pos: rlm.decode_step(p, t, ca, pos, rcfg)).lower(
        dense, x[:, 0], caches, jnp.int32(S)).compile(compiler_options=NO_EXCESS)
    return pf, ds


@pytest.mark.parametrize("name,bits", [("tiny-160k", 4), ("tiny-160k", 8), ("tiny-650k", 8),
                                       ("tiny-160k", 3), ("tiny-160k", 5), ("tiny-160k", 6)])
def test_engine_greedy_tokens_identical(name, bits):
    """Where the reference pins greedy-token identity (fused == dequant_einsum,
    tests/test_decode_consistency.py), the port's Engine gives the
    reference's greedy tokens (its prefill and decode steps, compiled as the
    grid compiles them, argmax as its Engine takes it) and pins the same
    identity across its own matmul modes.  At 3, 5 and 6 bits the reference
    has no such test; its own fused and dequant_einsum Engines give the same
    greedy tokens on tiny-160k there too (test_decode_consistency.py's
    prompts and lengths), so those widths are held to tokens, not logits."""
    rcfg, tcfg = _cfgs(name)
    prompts = np.random.RandomState(1).randint(0, rcfg.vocab_size, (3, 12)).astype(np.int32)
    S, N = 12, 10
    pf, ds = _ref_greedy_fns(name, S, N)
    dense = _quantized(name, bits)[1]
    logits, caches = pf(dense, jnp.asarray(prompts))
    ref = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for t in range(1, N):
        logits, caches = ds(dense, ref[-1], caches, jnp.int32(S + t - 1))
        ref.append(jnp.argmax(logits, -1).astype(jnp.int32))
    params = _port_weights(name, f"q{bits}")
    fused = Engine(params, tcfg, max_seq_len=S + N, matmul_mode="fused",
                   device="cpu").generate(prompts, N)
    deq = Engine(params, tcfg, max_seq_len=S + N, matmul_mode="dequant_einsum",
                 device="cpu").generate(prompts, N)
    np.testing.assert_array_equal(fused.numpy(), np.stack([np.asarray(r) for r in ref], 1))
    assert torch.equal(fused, deq)


def test_tiny650k_4bit_held_to_logits():
    """The reference's own fused-vs-dequant token identity fails at
    tiny-650k with 4-bit weights (ROADMAP queue C), so the port's two matmul
    modes are held to the logit bar there."""
    params = _port_weights("tiny-650k", "q4")
    for kv in (16, 4):
        gap = np.abs(_port_logits("tiny-650k", kv, params, "fused")
                     - _port_logits("tiny-650k", kv, params, "dequant_einsum")).max()
        assert gap < LOGIT_TOL


def test_engine_sampling_and_eos():
    _, tcfg = _cfgs("tiny-160k")
    params = _port_weights("tiny-160k", "q4")
    prompts = np.random.RandomState(2).randint(0, tcfg.vocab_size, (2, 6))
    g = torch.Generator().manual_seed(0)
    a = Engine(params, tcfg, max_seq_len=16, device="cpu").generate(
        prompts, 8, temperature=1.0, generator=g)
    g.manual_seed(0)
    b = Engine(params, tcfg, max_seq_len=16, device="cpu").generate(
        prompts, 8, temperature=1.0, generator=g)
    assert torch.equal(a, b) and a.shape == (2, 8) and a.dtype == torch.int32
    eos = int(a[0, 0])
    out = Engine(params, tcfg, max_seq_len=16, eos_id=eos, device="cpu").generate(
        prompts, 8, temperature=1.0, generator=g.manual_seed(0))
    assert (out[0] == eos).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_oracle_logit_gap_within_tolerance(bits):
    _, tcfg = _cfgs("tiny-160k")
    params = _port_weights("tiny-160k", "w16")
    prompts = np.random.RandomState(3).randint(0, tcfg.vocab_size, (2, 10))
    gap, agree = kv_oracle_logit_gap(params, tcfg.with_kv_quant(bits), prompts, 8,
                                     device="cpu")
    assert gap < KV_LOGIT_TOL[bits] and 0.0 <= agree <= 1.0


def test_init_params_keys_and_count():
    """The port's own init has the reference tree's keys and shapes."""
    rcfg, tcfg = _cfgs("qwen2-7b-reduced")
    ref = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
           jax.tree_util.tree_leaves_with_path(_weights("qwen2-7b-reduced")[0]["w16"])}
    own = {k: tuple(v.shape) for k, v in
           interop.flatten(lm.init_params(tcfg, seed=1, device="cpu")).items()}
    assert own == ref
    assert tcfg.param_count() == sum(int(np.prod(s)) for s in ref.values())
    assert get_arch("qwen2-7b").param_count() == rcfg.__class__.param_count(
        r_get_arch("qwen2-7b"))
