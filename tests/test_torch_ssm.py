"""The port's state-space and hybrid decoders (``models/ssm.py`` and the SSM
path through blocks, lm, quantize, the Engine and the Server) against the
JAX package, on the CPU.

Weights come from the reference's ``init_params(PRNGKey(0))`` (or
``init_ssm``) at ``reduced()`` shapes (mamba2-130m: 2 SSM layers, d 64,
d_inner 128, 8 heads of 16, state 16, SSD chunks of 8; jamba-v0.1-52b: 16
layers, two periods of one attention layer and seven SSM ones, MoE every
second, 4 experts of width 32) and are carried across with
``interop.params_from_reference``; inputs are numpy draws from fixed seeds.
The reference is compiled without XLA's excess precision.  The bars:

* configs field for field, ``count_params`` at full size, at ``reduced()``
  and with ``active_only`` the reference's;
* ``ssd_chunked`` within 1e-5 of the largest value of the reference's
  (f32 sums in another order), over seeds, chunks {4, 8, 16}, heads {2, 4}
  a group and groups {1, 2}, and within the reference's own 2e-3 of the
  port's per-step ``ssd_reference``;
* ``ssd_decode_step``, ``ssm_block`` and ``ssm_block_decode`` at mamba2's
  ``reduced()``: outputs within one bf16 ulp of their largest value (2^-7
  of it), states within 1e-5 of theirs, except the block's tail state,
  which is held to one bf16 ulp of its largest value: its inputs are the
  conv's bf16 outputs, and XLA contracts the conv's taps into fused
  multiply-adds and its exp (in the SiLU) differs from PyTorch's in the
  last f32 bit, either of which flips a bf16 rounding now and then (one in
  5,120 on this test's input); decode steps against the sequence at the
  reference's 3e-2 (outputs) and 2e-2 (final state and conv);
* the fixed init leaves (D, conv_b, the norm) bit for bit, A_log and
  dt_bias within two f32 ulps (XLA's f32 log and expm1 are approximations
  that land up to two ulps from the correctly rounded values the port
  takes);
* softplus the reference's logaddexp(x, 0), past F.softplus's threshold
  too, within two f32 ulps (XLA's exp and log1p against PyTorch's);
* 4-bit quantized trees bit for bit, in_proj and out_proj quantized, the
  conv, A_log, D, dt_bias and norm left as they are;
* backbone logits, and a prefill then 8 decode steps, within 0.08 of the
  reference's (the decode-consistency bar of
  tests/test_decode_consistency.py); the Engine's greedy tokens the
  reference Engine's (mamba2 at kv16, jamba at kv4);
* mamba2's Server (exact-length prefills, preemption) the reference
  Server's tokens and the per-request Engine's, a spilled state and conv
  restored bit for bit, ``paged`` and ``prefill_chunk`` refused, and a
  prompt that breaks the SSD chunk rule refused in both packages.
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
from repro.models import ssm as rssm  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import Server as RServer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.core.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.models import blocks, lm, ssm  # noqa: E402
from repro_torch.models.layers import Init  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.serving import Engine, Server  # noqa: E402

torch.set_num_threads(2)

SSM_ARCHS = ["mamba2-130m", "jamba-v0.1-52b"]
NO_EXCESS = {"xla_allow_excess_precision": False}
LOGIT_TOL = 0.08                 # tests/test_decode_consistency.py
CORE_REL = 1e-5                  # f32 sums in another order
CHUNK_VS_STEP = 2e-3             # tests/test_ssm_moe.py
DECODE_Y_TOL, DECODE_STATE_TOL = 3e-2, 2e-2   # tests/test_ssm_moe.py
BASE = dict(bits=4, dtype="float", block_size=64)
# jamba's experts at reduced() are 32 wide: whole blocks of 32 for the fused path
FUSED_BASE = dict(bits=4, dtype="float", block_size=32)


def _cfgs(name, kv=16):
    rcfg, tcfg = r_get_arch(name).reduced(), get_arch(name).reduced()
    return rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)


def _jit(f, *args):
    """f compiled without XLA's excess precision, called on args."""
    return jax.jit(f).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(reference tree, port tree) from the reference's PRNGKey(0) init."""
    rcfg, _ = _cfgs(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    return raw, interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")


@functools.lru_cache(maxsize=None)
def _ssm_weights():
    rcfg, _ = _cfgs("mamba2-130m")
    raw = jax.jit(lambda k: rssm.init_ssm(k, rcfg))(jax.random.PRNGKey(1))
    return raw, interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    t = np.asarray(t)
    return t.view(np.int16) if t.dtype.name == "bfloat16" else t.view(np.int32) \
        if t.dtype == np.uint32 else t


def _ulps(a, b):
    """The largest distance in f32 ulps between two f32 arrays."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
               .max())


def _rel(ref, mine):
    """max |ref - mine| over max |ref|."""
    ref, mine = _np(ref), _np(mine)
    return float(np.abs(ref - mine).max() / max(np.abs(ref).max(), 1e-30))


# -------------------------------------------------------------------------
# configs
# -------------------------------------------------------------------------

@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_configs_and_counts_equal_reference(name, active_only):
    ref, mine = r_get_arch(name), get_arch(name)
    assert dataclasses.asdict(mine) == {k: v for k, v in dataclasses.asdict(ref).items()
                                        if k != "kv_use_kernel"}
    assert lm.count_params(mine, active_only) == rlm.count_params(ref, active_only)
    assert lm.count_params(mine.reduced(), active_only) == rlm.count_params(ref.reduced(),
                                                                            active_only)
    eight = dataclasses.replace(mine, n_layers=8)
    assert lm.count_params(eight, active_only) == rlm.count_params(
        dataclasses.replace(ref, n_layers=8), active_only)


def test_schedules_and_tree_keys_equal_reference():
    """mamba2's layers have no FFN (no ffn_norm, no ffn), jamba's period
    is the reference's; the param and cache trees carry its keys."""
    assert blocks.stack_schedule(get_arch("mamba2-130m")) == [("ssm", None)]
    assert blocks.stack_schedule(get_arch("jamba-v0.1-52b")) == [
        ("attn", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
        ("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe")]
    for name in SSM_ARCHS:
        rcfg, tcfg = _cfgs(name)
        raw, _ = _weights(name)
        mine = lm.init_params(tcfg, seed=0, device="cpu")
        assert set(interop.flatten(mine)) == set(interop.flatten(
            interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")))
        rc = jax.eval_shape(lambda: rlm.init_caches(rcfg, 2, 16))
        tc = lm.init_caches(tcfg, 2, 16, device="cpu")
        assert [sorted(g) for g in rc] == [sorted(g) for g in tc]
        for rg, tg in zip(rc, tc):
            for k in rg:
                assert tuple(rg[k].shape) == tuple(tg[k].shape), (name, k)
                assert str(rg[k].dtype) == str(tg[k].dtype).replace("torch.", ""), (name, k)


# -------------------------------------------------------------------------
# the SSD core
# -------------------------------------------------------------------------

def _ssd_inputs(seed, heads, groups, B=2, S=32, P=8, N=16):
    """The reference's hypothesis test's shapes, from a numpy seed."""
    rs = np.random.RandomState(seed)
    H = heads * groups
    x = rs.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, S, H))).astype(np.float32)
    A = -np.exp(rs.randn(H)).astype(np.float32)
    Bm = rs.randn(B, S, groups, N).astype(np.float32)
    Cm = rs.randn(B, S, groups, N).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunked_matches_reference(seed, chunk, heads, groups):
    """The port's chunked scan against the reference's (y and the final
    state within CORE_REL of their largest values; groups > 1 shows the
    group-to-head broadcast is jnp.repeat's) and against its own per-step
    recurrence within the reference's 2e-3."""
    args = _ssd_inputs(seed, heads, groups)
    ry, rh = _jit(lambda *a: rssm.ssd_chunked(*a, chunk=chunk), *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    ty, th = ssm.ssd_chunked(*targs, chunk)
    assert _rel(ry, ty) <= CORE_REL and _rel(rh, th) <= CORE_REL, (_rel(ry, ty), _rel(rh, th))
    sy, sh = ssm.ssd_reference(*targs)
    assert np.abs(_np(sy) - _np(ty)).max() <= CHUNK_VS_STEP
    assert np.abs(_np(sh) - _np(th)).max() <= CHUNK_VS_STEP


def test_ssd_reference_and_initial_state_match_reference():
    """The per-step oracle against the reference's, and both scans from a
    non-zero initial state."""
    x, dt, A, Bm, Cm = _ssd_inputs(5, 2, 2)
    h0 = np.random.RandomState(6).randn(2, 4, 8, 16).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    targs = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    ry, rh = _jit(lambda *a: rssm.ssd_reference(*a[:5], initial_state=a[5]), *jargs,
                  jnp.asarray(h0))
    ty, th = ssm.ssd_reference(*targs, initial_state=torch.from_numpy(h0))
    assert _rel(ry, ty) <= CORE_REL and _rel(rh, th) <= CORE_REL
    cy, ch = _jit(lambda *a: rssm.ssd_chunked(*a[:5], chunk=8, initial_state=a[5]), *jargs,
                  jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(*targs, 8, initial_state=torch.from_numpy(h0))
    assert _rel(cy, ty) <= CORE_REL and _rel(ch, th) <= CORE_REL


def test_ssd_decode_step_matches_reference():
    """One token at mamba2's reduced() shapes (8 heads of 16, one group,
    state 16) from a non-zero state."""
    rcfg, _ = _cfgs("mamba2-130m")
    H, P, N, B = rcfg.n_ssm_heads, rcfg.ssm_head_dim, rcfg.ssm_state, 3
    rs = np.random.RandomState(3)
    state = rs.randn(B, H, P, N).astype(np.float32)
    x = rs.randn(B, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, H))).astype(np.float32)
    A = -np.exp(rs.randn(H)).astype(np.float32)
    Bt, Ct = rs.randn(B, 1, N).astype(np.float32), rs.randn(B, 1, N).astype(np.float32)
    args = (state, x, dt, A, Bt, Ct)
    ry, rs_ = _jit(rssm.ssd_decode_step, *map(jnp.asarray, args))
    ty, ts = ssm.ssd_decode_step(*[torch.from_numpy(a) for a in args])
    assert _rel(ry, ty) <= CORE_REL and _rel(rs_, ts) <= CORE_REL


def test_chunk_rule_refused_in_both_packages():
    """A sequence that is not a multiple of its chunk raises, never pads."""
    x, dt, A, Bm, Cm = _ssd_inputs(0, 2, 1, S=12)
    with pytest.raises(AssertionError, match="divisible by ssd chunk"):
        rssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=8)
    with pytest.raises(ValueError, match="divisible by ssd chunk"):
        ssm.ssd_chunked(*[torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)], 8)


# -------------------------------------------------------------------------
# the block
# -------------------------------------------------------------------------

def _u(B, S, D, seed=0):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def test_ssm_block_matches_reference():
    """The mixer in sequence mode on bf16 input (two SSD chunks): output
    and tail state within one bf16 ulp of their largest values (the state's
    inputs are bf16: see the module docstring), the conv tail bit for bit
    (the input rows as stored)."""
    rcfg, tcfg = _cfgs("mamba2-130m")
    raw, tp = _ssm_weights()
    u = _u(2, 16, rcfg.d_model)
    ry, rtail = _jit(lambda p, u: rssm.ssm_block(p, u, rcfg), raw,
                     jnp.asarray(u).astype(jnp.bfloat16))
    with torch.inference_mode():
        ty, ttail = ssm.ssm_block(tp, torch.from_numpy(u).to(torch.bfloat16), tcfg)
    assert ty.dtype == torch.bfloat16 and _rel(ry, ty) <= 2.0 ** -7, _rel(ry, ty)
    assert ttail["state"].dtype == torch.float32
    assert _rel(rtail["state"], ttail["state"]) <= 2.0 ** -7, _rel(rtail["state"],
                                                                 ttail["state"])
    assert np.array_equal(_bits(rtail["conv"]), _bits(ttail["conv"]))


def test_ssm_block_decode_matches_reference():
    """Four decode steps from a prefilled tail: each output within one bf16
    ulp of its largest value, the state within CORE_REL, the conv tail bit
    for bit, updated in place."""
    rcfg, tcfg = _cfgs("mamba2-130m")
    raw, tp = _ssm_weights()
    u = _u(2, 12, rcfg.d_model, seed=4)
    pre = jnp.asarray(u[:, :8]).astype(jnp.bfloat16)
    _, rcache = _jit(lambda p, u: rssm.ssm_block(p, u, rcfg), raw, pre)
    with torch.inference_mode():
        _, tcache = ssm.ssm_block(tp, torch.from_numpy(u[:, :8]).to(torch.bfloat16), tcfg)
        tcache = {k: v.contiguous() for k, v in tcache.items()}
        ptrs = {k: v.data_ptr() for k, v in tcache.items()}
        step = jax.jit(lambda p, u, c: rssm.ssm_block_decode(p, u, c, rcfg))
        for t in range(8, 12):
            ut = jnp.asarray(u[:, t]).astype(jnp.bfloat16)
            ry, rcache = step.lower(raw, ut, rcache).compile(compiler_options=NO_EXCESS)(
                raw, ut, rcache)
            ty = ssm.ssm_block_decode(tp, torch.from_numpy(u[:, t]).to(torch.bfloat16),
                                      tcache, tcfg)
            assert _rel(ry, ty) <= 2.0 ** -7, (t, _rel(ry, ty))
            assert _rel(rcache["state"], tcache["state"]) <= CORE_REL, t
            assert np.array_equal(_bits(rcache["conv"]), _bits(tcache["conv"])), t
    assert {k: v.data_ptr() for k, v in tcache.items()} == ptrs


def test_decode_steps_equal_sequence():
    """The reference's own test on the port: f32 input, an f32 cache, the
    decode steps against the sequence at 3e-2 and the final state and conv
    at 2e-2."""
    _, tcfg = _cfgs("mamba2-130m")
    params = ssm.init_ssm(Init(0, torch.device("cpu")), tcfg)
    B, S = 2, 16
    u = torch.from_numpy(_u(B, S, tcfg.d_model, seed=1)) * 0.5
    with torch.inference_mode():
        y_seq, tail = ssm.ssm_block(params, u, tcfg)
        cache = ssm.init_ssm_cache(tcfg, B, dtype=torch.float32)
        y_dec = torch.stack([ssm.ssm_block_decode(params, u[:, t], cache, tcfg)
                             for t in range(S)], dim=1)
    assert float((y_seq - y_dec).abs().max()) <= DECODE_Y_TOL
    assert float((tail["state"] - cache["state"]).abs().max()) <= DECODE_STATE_TOL
    assert float((tail["conv"] - cache["conv"]).abs().max()) <= DECODE_STATE_TOL


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_fixed_init_leaves_match_reference(name):
    """The leaves init_ssm does not draw, against the reference's init_ssm
    at reduced() (and mamba2 at full width, 24 heads) and its formulas at
    jamba's 128 heads: D, conv_b and the norm bit for bit, A_log and
    dt_bias within two f32 ulps (see the module docstring)."""
    rcfg, tcfg = _cfgs(name)
    rp = jax.jit(lambda k: rssm.init_ssm(k, rcfg))(jax.random.PRNGKey(0))
    tp = ssm.init_ssm(Init(0, torch.device("cpu")), tcfg)
    for key in ("conv_b", "D"):
        assert np.array_equal(np.asarray(rp[key]), tp[key].numpy()), key
    assert np.array_equal(np.asarray(rp["norm"]["scale"]), tp["norm"]["scale"].numpy())
    refs = [(rp, tp)]
    full = r_get_arch(name)
    if name == "mamba2-130m":
        refs.append((jax.jit(lambda k: rssm.init_ssm(k, full))(jax.random.PRNGKey(0)),
                     ssm.fixed_leaves(full.n_ssm_heads)))
    else:
        H = full.n_ssm_heads
        refs.append((jax.jit(lambda: {
            "A_log": jnp.log(jnp.linspace(1.0, 16.0, H, dtype=jnp.float32)),
            "D": jnp.ones((H,), jnp.float32),
            "dt_bias": jnp.log(jnp.expm1(jnp.linspace(1e-3, 1e-1, H, dtype=jnp.float32)))})(),
            ssm.fixed_leaves(H)))
    for r, t in refs:
        assert np.array_equal(np.asarray(r["D"]), t["D"].numpy())
        for key in ("A_log", "dt_bias"):
            a, b = np.asarray(r[key]), t[key].numpy()
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert _ulps(a, b) <= 2, (key, _ulps(a, b))


def test_softplus_is_logaddexp_past_the_threshold():
    """jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself past
    20.  The port's formula gives the reference's values over [-40, 40]
    within two f32 ulps of them, and dt's softplus follows it."""
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.array([20.0, 20.5, 25.0, 1e-30, 0.0], np.float32)])
    ref = np.asarray(_jit(jax.nn.softplus, jnp.asarray(x)))
    mine = ssm.softplus(torch.from_numpy(x)).numpy()
    assert _ulps(ref, mine) <= 2, _ulps(ref, mine)
    big = torch.tensor([20.5, 30.0])
    assert torch.equal(ssm.softplus(big), big + torch.log1p(torch.exp(-big)))


# -------------------------------------------------------------------------
# quantized trees and the model
# -------------------------------------------------------------------------

@pytest.mark.parametrize("name", SSM_ARCHS)
def test_quantized_tree_bit_exact_to_reference(name):
    """The 4-bit tree of tests/test_quantize_params.py's SSM case, every leaf
    bit for bit: in_proj and out_proj (and jamba's attention, MLPs and
    experts) quantized, the conv, A_log, D, dt_bias and norms as they were."""
    rcfg, tcfg = _cfgs(name)
    raw, params = _weights(name)
    rq = jax.jit(lambda p: r_quantize_params(p, RQuantConfig(**BASE), rcfg))(raw)
    tq = quantize_params(params, QuantConfig(**BASE), tcfg, device="cpu")
    carried = interop.flatten(interop.params_from_reference(jax.tree.map(np.asarray, rq),
                                                            device="cpu"))
    own = interop.flatten(tq)
    assert set(own) == set(carried)
    for key, a in carried.items():
        assert a.dtype == own[key].dtype and np.array_equal(_bits(a), _bits(own[key])), key
    j = blocks.stack_schedule(tcfg).index(("ssm", None if name == "mamba2-130m" else "moe"))
    mixer = tq["stack"][j]["mixer"]
    assert isinstance(mixer["in_proj"]["w"], QuantizedTensor)
    assert isinstance(mixer["out_proj"]["w"], QuantizedTensor)
    for key in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert mixer[key].dtype == torch.float32, key


@functools.lru_cache(maxsize=None)
def _quantized(name):
    rcfg, tcfg = _cfgs(name)
    raw, params = _weights(name)
    base = FUSED_BASE if rcfg.n_experts else BASE
    rq = jax.jit(lambda p: r_quantize_params(p, RQuantConfig(**base), rcfg))(raw)
    tq = quantize_params(params, QuantConfig(**base), tcfg, device="cpu")
    return rq, tq


@pytest.mark.parametrize("mode", ["fused", "dequant_einsum"])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_backbone_logits_match_reference(name, mode):
    """4-bit weights: the port's logits over 2 x 24 tokens (three SSD
    chunks) within 0.08 of the reference's."""
    rcfg, tcfg = _cfgs(name)
    rq, tq = _quantized(name)
    tcfg = tcfg.with_matmul_mode(mode)
    toks = np.random.RandomState(2).randint(0, rcfg.vocab_size, (2, 24)).astype(np.int32)
    ref = _np(_jit(lambda p, t: rlm.logits_from_hidden(p, rlm.backbone_seq(p, t, rcfg)[0],
                                                       rcfg), rq, jnp.asarray(toks)))
    with torch.inference_mode():
        h, _ = lm.backbone_seq(tq, torch.from_numpy(toks).long(), tcfg)
        mine = _np(lm.logits_from_hidden(tq, h, tcfg))
    assert float(np.abs(ref - mine).max()) < LOGIT_TOL


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_prefill_and_decode_logits_match_reference(name):
    """A prefill of 16 tokens, then 8 decode steps fed the same tokens in
    both packages (jamba at kv4): every step's logits within 0.08."""
    kv = 4 if name == "jamba-v0.1-52b" else 16
    rcfg, tcfg = _cfgs(name, kv)
    rq, tq = _quantized(name)
    B, S, N = 2, 16, 8
    toks = np.random.RandomState(3).randint(0, rcfg.vocab_size, (B, S + N)).astype(np.int32)
    logits, caches = _jit(lambda p, t: rlm.prefill(p, t, rcfg, cache_len=S + N), rq,
                          jnp.asarray(toks[:, :S]))
    step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, t, c, pos, rcfg)).lower(
        rq, jnp.asarray(toks[:, S]), caches, jnp.int32(S)).compile(compiler_options=NO_EXCESS)
    ref = [_np(logits)]
    for t in range(N):
        logits, caches = step(rq, jnp.asarray(toks[:, S + t]), caches, jnp.int32(S + t))
        ref.append(_np(logits))
    with torch.inference_mode():
        tl, tc = lm.prefill(tq, torch.from_numpy(toks[:, :S]).long(), tcfg, cache_len=S + N)
        mine = [_np(tl)]
        for t in range(N):
            tl, tc = lm.decode_step(tq, torch.from_numpy(toks[:, S + t]).long(), tc, S + t, tcfg)
            mine.append(_np(tl))
    gap = float(np.abs(np.stack(ref) - np.stack(mine)).max())
    assert gap < LOGIT_TOL, gap


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_engine_greedy_tokens_match_reference(name):
    """The Engine on 4-bit weights (mamba2 at kv16, jamba at kv4): the
    port's greedy tokens the reference Engine's, a near-tie within 0.08 of
    the reference's maximum allowed (teacher-forced)."""
    kv = 4 if name == "jamba-v0.1-52b" else 16
    rcfg, tcfg = _cfgs(name, kv)
    rq, tq = _quantized(name)
    B, S, N = 2, 16, 10
    prompts = np.random.RandomState(4).randint(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    toks = Engine(tq, tcfg, max_seq_len=S + N, device="cpu").generate(prompts, N).numpy()
    ref_toks = np.asarray(REngine(rq, rcfg, max_seq_len=S + N).generate(jnp.asarray(prompts),
                                                                       N))
    if not np.array_equal(toks, ref_toks):   # teacher-forced near-ties
        logits, caches = _jit(lambda p, t: rlm.prefill(p, t, rcfg, cache_len=S + N), rq,
                              jnp.asarray(prompts))
        step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, t, c, pos, rcfg)).lower(
            rq, jnp.asarray(toks[:, 0]), caches, jnp.int32(S)).compile(
            compiler_options=NO_EXCESS)
        ref = [_np(logits)]
        for t in range(N - 1):
            logits, caches = step(rq, jnp.asarray(toks[:, t]), caches, jnp.int32(S + t))
            ref.append(_np(logits))
        ref = np.stack(ref)
        chosen = np.take_along_axis(ref, toks.T[..., None], -1)[..., 0]
        assert (ref.max(-1) - chosen <= LOGIT_TOL).all(), (toks, ref_toks)
        assert (toks == ref.argmax(-1).T).mean() > 0.9, (toks, ref_toks)


# -------------------------------------------------------------------------
# the Server
# -------------------------------------------------------------------------

def _serve(srv, prompts, budgets, arrivals, priorities=None):
    priorities = priorities or [0] * len(prompts)
    ids = [srv.submit(p, m, arrival_time=a, priority=pr)
           for p, m, a, pr in zip(prompts, budgets, arrivals, priorities)]
    res = srv.run_until_drained()
    return [[int(t) for t in res[i]] for i in ids]


#: prompts that keep the SSD chunk rule at reduced() (chunks of 8): at most
#: 8 tokens, or a multiple of 8
SERVER_LENS, SERVER_BUDGETS = [16, 5, 8, 24, 3], [10, 12, 6, 8, 14]


def test_server_matches_reference_server_and_engine(monkeypatch):
    """mamba2 on 2 slots: every prefill at the prompt's exact length; the
    port's tokens the reference Server's and the per-request Engine's; then
    two priority classes with preemption: the same tokens, and each
    restored state and conv bit for bit its spill."""
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=NO_EXCESS))
    rcfg, tcfg = _cfgs("mamba2-130m")
    raw, params = _weights("mamba2-130m")
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, tcfg.vocab_size, L) for L in SERVER_LENS]
    arrivals = [1.0 * i for i in range(len(prompts))]
    cache = 40
    seen = []
    real = lm.backbone_seq
    monkeypatch.setattr(lm, "backbone_seq", lambda p, t, *a, **k: seen.append(t.shape[1])
                        or real(p, t, *a, **k))
    mine = _serve(Server(params, tcfg, num_slots=2, max_seq_len=cache, device="cpu"),
                  prompts, SERVER_BUDGETS, arrivals)
    assert seen == SERVER_LENS
    ref = _serve(RServer(raw, rcfg, num_slots=2, max_seq_len=cache), prompts, SERVER_BUDGETS,
                 arrivals)
    assert mine == ref
    for i, (p, m) in enumerate(zip(prompts, SERVER_BUDGETS)):
        eng = Engine(params, tcfg, max_seq_len=cache, device="cpu").generate(p[None], m)
        assert mine[i] == eng[0].tolist(), i
    srv = Server(params, tcfg, num_slots=2, max_seq_len=cache, max_preemptions=2, device="cpu")
    spills, restored = [], []
    real_spill, real_restore = srv.pool.spill_slot, srv.pool.restore_slot
    srv.pool.spill_slot = lambda slot: spills.append(real_spill(slot)) or spills[-1]

    def restore(slot, spill):
        real_restore(slot, spill)
        restored.append((spill, real_spill(slot)))

    srv.pool.restore_slot = restore
    sla = _serve(srv, prompts, SERVER_BUDGETS, [0.0, 0.0, 6.0, 7.0, 8.0], [1, 1, 0, 0, 0])
    assert srv.scheduler.n_preemptions >= 1 and len(restored) == srv.scheduler.n_preemptions
    assert sla == mine
    for spill, again in restored:
        for a, b in zip(spill["rows"], again["rows"]):
            assert set(a) == {"state", "conv"}
            for key in a:
                assert np.array_equal(_bits(a[key]), _bits(b[key])), key
        assert spill["bytes_packed"] == 0    # no K/V: SSM leaves are not counted


def test_server_refuses_paged_chunked_and_off_chunk_prompts():
    """The reference's refusals before any step, and a prompt that breaks
    the SSD chunk rule (12 tokens, chunks of 8) raised at its prefill, in
    the port's Server and in the reference's."""
    rcfg, tcfg = _cfgs("mamba2-130m")
    raw, params = _weights("mamba2-130m")
    with pytest.raises(ValueError, match="paged serving requires causal full attention"):
        Server(params, tcfg, num_slots=2, max_seq_len=32, paged=True, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk needs a bucketing-safe arch"):
        Server(params, tcfg, num_slots=2, max_seq_len=32, prefill_chunk=8, device="cpu")
    ws = lm.init_caches(get_arch("jamba-v0.1-52b").reduced(), 1, 16, device="cpu")
    jraw, jparams = _weights("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="dense MLPs only"):
        lm.backbone_chunk(jparams, torch.zeros((1, 8), dtype=torch.long), ws, 0,
                          get_arch("jamba-v0.1-52b").reduced())
    prompt = np.arange(1, 13)
    srv = Server(params, tcfg, num_slots=2, max_seq_len=32, device="cpu")
    srv.submit(prompt, 4)
    with pytest.raises(ValueError, match="divisible by ssd chunk"):
        srv.run_until_drained()
    rsrv = RServer(raw, rcfg, num_slots=2, max_seq_len=32)
    rsrv.submit(prompt, 4)
    with pytest.raises(AssertionError, match="divisible by ssd chunk"):
        rsrv.run_until_drained()


def test_jamba_server_matches_per_request_engine():
    """jamba at kv4 on 2 slots (attention and SSM caches in one pool, MoE
    with the idle rows masked): each request's tokens the per-request
    Engine's."""
    _, tcfg = _cfgs("jamba-v0.1-52b", 4)
    _, tq = _quantized("jamba-v0.1-52b")
    rs = np.random.RandomState(10)
    lens, budgets = [16, 5, 8], [6, 8, 5]
    prompts = [rs.randint(1, tcfg.vocab_size, L) for L in lens]
    out = _serve(Server(tq, tcfg, num_slots=2, max_seq_len=32, device="cpu"), prompts,
                 budgets, [0.0, 1.0, 2.0])
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        eng = Engine(tq, tcfg, max_seq_len=32, device="cpu").generate(p[None], m)
        assert out[i] == eng[0].tolist(), i
