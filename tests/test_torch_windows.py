"""The port's sliding-window and local/global decoders (ring KV caches,
period-2 stacks, sandwich norms) against the JAX package, on the CPU.

Weights come from the reference's ``init_params(PRNGKey(0))`` at
``reduced()`` shapes (danube: 2 layers, a window of 16 on each; gemma2: 4
layers alternating local (window 16) and global, sandwich norms, soft-caps
50 and 30, gelu, a tied head) and are carried across with
``interop.params_from_reference``.  The reference's steps are compiled
without XLA's excess precision, as in ``tests/test_torch_model.py``.  The
bars:

* configs: the four new configs field for field, ``count_params`` at full
  size equal to the reference's, the two MoE archs served (backbone logits
  within 0.08; the encoder-decoder's tests are tests/test_torch_seq2seq.py);
* ``backbone_seq`` logits of all four archs within 0.08 of the reference's
  (the decode-consistency bar of tests/test_decode_consistency.py; the gaps
  are 0.0 to 0.008);
* the ring: the reference's ``test_sliding_window_ring_cache_evicts_
  correctly`` (decode from position 8 to 40 within 0.08 of the full
  forward, rings of 16 slots), and each step's logits within 0.08 of the
  reference's own ``decode_step`` at kv16, kv8 and kv4 after a prefill
  longer than the ring;
* cache writes: ``write_cache_prefill`` of a prompt longer than the ring
  and ``write_cache_decode`` at a shared and at per-row positions with idle
  rows land the reference's leaves and positions bit for bit, bf16 and
  packed;
* unit names and quantized trees over two-position stacks bit for bit
  (gemma2's tied head stays the dense embedding, with no ``lm_head`` unit);
* the Engine's greedy tokens the reference's (a near-tie within 0.08 of the
  reference's maximum allowed, as in test_torch_encode_attention.py) at
  kv16, kv8 and kv4;
* the Server on danube equal to the per-request Engine, prefilling at the
  exact prompt length, a preempted wrapped ring restored bit for bit, and
  ``paged`` and ``prefill_chunk`` refused with the reference's errors.
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
from repro.kernels import kv_dequant as rkv  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import quantizable_units as r_units  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.kernels import kv_dequant as tkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quantize import quantizable_units, quantize_params  # noqa: E402
from repro_torch.serving import Engine, Server  # noqa: E402

torch.set_num_threads(2)

LOGIT_TOL = 0.08                 # tests/test_decode_consistency.py
NO_EXCESS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
NEW_ARCHS = ["h2o-danube-3-4b", "gemma2-27b", "deepseek-coder-33b", "chameleon-34b"]
#: ported after this file's slice (tests/test_torch_moe.py holds them in full)
MOE_ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
WINDOWED = ["h2o-danube-3-4b", "gemma2-27b"]
#: the ring test's cells: a prompt longer than the window (16 at reduced()),
#: then decode steps up to the cache length
B, PROMPT, CACHE = 2, 20, 40


def _cfgs(name, kv=16):
    rcfg, tcfg = r_get_arch(name).reduced(), get_arch(name).reduced()
    return rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(reference tree, port tree) from the reference's PRNGKey(0) init."""
    rcfg, _ = _cfgs(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    return raw, interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")


def _tokens(name, n=CACHE, seed=7):
    rcfg, _ = _cfgs(name)
    return np.random.RandomState(seed).randint(0, rcfg.vocab_size, (B, n)).astype(np.int32)


def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    t = np.asarray(t)
    return t.view(np.int16) if t.dtype.name == "bfloat16" else t.view(np.int32) \
        if t.dtype == np.uint32 else t


# -------------------------------------------------------------------------
# configs and the registry
# -------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW_ARCHS)
def test_configs_and_full_size_counts_equal_reference(name):
    ref, mine = r_get_arch(name), get_arch(name)
    # every field but the reference's Pallas opt-in, which the port drops
    assert dataclasses.asdict(mine) == {k: v for k, v in dataclasses.asdict(ref).items()
                                        if k != "kv_use_kernel"}
    assert lm.count_params(mine) == rlm.count_params(ref)
    assert lm.count_params(mine.reduced()) == rlm.count_params(ref.reduced())


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_archs_ported_and_backbone_matches_reference(name):
    """The MoE archs, ported after this file's slice: their configs are the
    reference's, and their backbone logits at reduced() (raw weights, the
    ring test's tokens) within 0.08 of the reference's."""
    ref, mine = r_get_arch(name), get_arch(name)
    assert mine.n_experts == ref.n_experts
    gap = float(np.abs(_ref_backbone_logits(name) - _port_backbone_logits(name)).max())
    assert gap < LOGIT_TOL, (name, gap)


# -------------------------------------------------------------------------
# the forward pass and the ring
# -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_backbone_logits(name):
    rcfg, _ = _cfgs(name)
    raw, _ = _weights(name)
    toks = jnp.asarray(_tokens(name))
    f = jax.jit(lambda p, t: rlm.logits_from_hidden(p, rlm.backbone_seq(p, t, rcfg)[0], rcfg))
    return np.asarray(f.lower(raw, toks).compile(compiler_options=NO_EXCESS)(raw, toks),
                      np.float32)


def _port_backbone_logits(name, cfg=None):
    _, tcfg = _cfgs(name)
    _, params = _weights(name)
    with torch.inference_mode():
        h, _ = lm.backbone_seq(params, torch.from_numpy(_tokens(name)).long(), cfg or tcfg)
        return lm.logits_from_hidden(params, h, cfg or tcfg).float().numpy()


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_backbone_logits_match_reference(name):
    gap = float(np.abs(_ref_backbone_logits(name) - _port_backbone_logits(name)).max())
    assert gap < LOGIT_TOL, (name, gap)


@pytest.mark.parametrize("name", WINDOWED)
def test_ring_cache_evicts_correctly(name):
    """The reference's test_sliding_window_ring_cache_evicts_correctly on
    the port: decoding from position 8 to 40, past the window of 16, each
    step within 0.08 of the full forward's logits at that position; every
    windowed layer's cache stays a ring of 16 slots, a global layer's holds
    all 40."""
    _, tcfg = _cfgs(name)
    _, params = _weights(name)
    toks = torch.from_numpy(_tokens(name)).long()
    full = _port_backbone_logits(name)
    with torch.inference_mode():
        logits, caches = lm.prefill(params, toks[:, :8], tcfg, cache_len=CACHE)
        for t in range(8, CACHE):
            logits, caches = lm.decode_step(params, toks[:, t], caches, t, tcfg)
            err = float(np.abs(logits.float().numpy() - full[:, t]).max())
            assert err < LOGIT_TOL, (t, err)
    assert caches[0]["k"].shape[2] == tcfg.sliding_window == 16
    if name == "gemma2-27b":
        assert len(caches) == 2 and caches[1]["k"].shape[2] == CACHE


@functools.lru_cache(maxsize=None)
def _ref_steps(name, kv):
    """The reference's prefill (cache_len CACHE) and decode step, compiled
    without excess precision."""
    rcfg, _ = _cfgs(name, kv)
    raw, _ = _weights(name)
    toks = jnp.asarray(_tokens(name))
    pf = jax.jit(lambda p, x: rlm.prefill(p, x, rcfg, cache_len=CACHE)).lower(
        raw, toks[:, :PROMPT]).compile(compiler_options=NO_EXCESS)
    _, caches = pf(raw, toks[:, :PROMPT])
    ds = jax.jit(lambda p, t, ca, pos: rlm.decode_step(p, t, ca, pos, rcfg)).lower(
        raw, toks[:, PROMPT], caches, jnp.int32(PROMPT)).compile(compiler_options=NO_EXCESS)
    return pf, ds


def _ref_run(name, kv, feed):
    """The reference's logits [steps, B, V] and argmax tokens, prefilling
    the first PROMPT tokens and then feeding ``feed`` [B, steps - 1]."""
    raw, _ = _weights(name)
    pf, ds = _ref_steps(name, kv)
    logits, caches = pf(raw, jnp.asarray(_tokens(name)[:, :PROMPT]))
    out = [np.asarray(logits, np.float32)]
    for t in range(feed.shape[1]):
        logits, caches = ds(raw, jnp.asarray(feed[:, t]), caches, jnp.int32(PROMPT + t))
        out.append(np.asarray(logits, np.float32))
    logits = np.stack(out)
    return logits, logits.argmax(-1).T


@pytest.mark.parametrize("kv", [16, 8, 4])
@pytest.mark.parametrize("name", WINDOWED)
def test_ring_decode_matches_reference_decode_step(name, kv):
    """A prefill of 20 tokens wraps each 16-slot ring; then teacher-forced
    decode steps to position 40, each step's logits within 0.08 of the
    reference's decode_step on the same caches' contents."""
    _, tcfg = _cfgs(name, kv)
    _, params = _weights(name)
    toks = _tokens(name)
    ref, _ = _ref_run(name, kv, toks[:, PROMPT:CACHE - 1])
    mine = []
    with torch.inference_mode():
        tt = torch.from_numpy(toks).long()
        logits, caches = lm.prefill(params, tt[:, :PROMPT], tcfg, cache_len=CACHE)
        mine.append(logits.float().numpy())
        for t in range(PROMPT, CACHE - 1):
            logits, caches = lm.decode_step(params, tt[:, t], caches, t, tcfg)
            mine.append(logits.float().numpy())
    gap = float(np.abs(np.stack(mine) - ref).max())
    assert gap < LOGIT_TOL, (name, kv, gap)


# -------------------------------------------------------------------------
# ring cache writes, bit for bit
# -------------------------------------------------------------------------

def _kv_rows(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(jnp.bfloat16)


def _t(a):
    return interop.tensor_from_numpy(a, device="cpu")


def _assert_cache_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert np.array_equal(_bits(port[key]), _bits(ref[key])), key


@pytest.mark.parametrize("kv", [16, 8, 4])
def test_ring_cache_writes_bit_equal(kv):
    """A prompt of 27 into a 16-slot ring (window 16) keeps positions 11..26
    at their ring slots; then a shared decode write at 27 and per-row writes
    at [30, -1] (an idle row) over a per-slot ring: leaves and positions are
    the reference's, bf16 and packed."""
    rcfg, tcfg = _cfgs("h2o-danube-3-4b", kv)
    K, Dh, S_c, S, W = tcfg.n_kv_heads, tcfg.head_dim, 16, 27, tcfg.sliding_window
    rspec, tspec = rkv.kv_spec(rcfg), tkv.kv_spec(tcfg)
    k, v = _kv_rows((B, S, K, Dh), 1), _kv_rows((B, S, K, Dh), 2)
    ref = rattn.write_cache_prefill(rattn.init_kv_cache(rcfg, B, S_c, kvq=rspec),
                                    jnp.asarray(k), jnp.asarray(v), window=W, kvq=rspec)
    port = tattn.write_cache_prefill(tattn.init_kv_cache(tcfg, B, S_c, kvq=tspec),
                                     _t(k), _t(v),
                                     window=W, kvq=tspec)
    _assert_cache_equal(port, ref)
    assert sorted(np.asarray(ref["pos"]).tolist()) == list(range(S - S_c, S))
    kn, vn = _kv_rows((B, K, Dh), 3), _kv_rows((B, K, Dh), 4)
    ref = rattn.write_cache_decode(ref, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(S),
                                   window=W, kvq=rspec)
    tattn.write_cache_decode(port, _t(kn), _t(vn),
                             torch.tensor(S, dtype=torch.int32), window=W, kvq=tspec)
    _assert_cache_equal(port, ref)
    # per-slot rings: each row at its own position, row 1 idle
    rrow = dict(ref, pos=jnp.stack([ref["pos"]] * B))
    trow = dict(port, pos=torch.stack([port["pos"]] * B))
    pos = np.array([30, -1], np.int32)
    rrow = rattn.write_cache_decode(rrow, jnp.asarray(vn), jnp.asarray(kn), jnp.asarray(pos),
                                    window=W, kvq=rspec)
    tattn.write_cache_decode(trow, _t(vn), _t(kn),
                             torch.from_numpy(pos), window=W, kvq=tspec)
    _assert_cache_equal(trow, rrow)
    assert int(trow["pos"][0, 30 % S_c]) == 30 and int(trow["pos"][1, S_c - 1]) == -1


# -------------------------------------------------------------------------
# quantized trees over two-position stacks
# -------------------------------------------------------------------------

def test_gemma2_units_and_quantized_tree_equal_reference():
    """Two period positions name their units stack/0/... and stack/1/...
    (with the sandwich norms left dense), the tied head is the dense
    embedding (no lm_head unit), and the port's 4-bit tree is the
    reference's leaf for leaf."""
    rcfg, tcfg = _cfgs("gemma2-27b")
    raw, params = _weights("gemma2-27b")
    base = dict(bits=4, dtype="float", block_size=64)
    ref_units = r_units(raw, rcfg, RQuantConfig(**base))
    mine = quantizable_units(params, tcfg, QuantConfig(**base))
    assert list(mine) == list(ref_units)
    assert {u.split("/")[1] for u in mine if u.startswith("stack/")} == {"0", "1"}
    assert "lm_head" not in mine and "embed" not in mine
    rq = jax.jit(lambda p: r_quantize_params(p, RQuantConfig(**base), rcfg))(raw)
    tq = quantize_params(params, QuantConfig(**base), tcfg, device="cpu")
    carried = interop.flatten(interop.params_from_reference(jax.tree.map(np.asarray, rq),
                                                            device="cpu"))
    own = interop.flatten(tq)
    keys = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(rq)}
    assert set(own) == set(carried) == keys
    assert any("post_ffn_norm" in k for k in keys)
    for key, a in carried.items():
        assert a.dtype == own[key].dtype and np.array_equal(_bits(a), _bits(own[key])), key


# -------------------------------------------------------------------------
# the Engine and the Server
# -------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [16, 8, 4])
@pytest.mark.parametrize("name", WINDOWED)
def test_engine_greedy_tokens_match_reference(name, kv):
    """The Engine from a prompt longer than the ring: each greedy token is
    the reference's argmax, teacher-forced on the port's tokens, or within
    0.08 of the reference's maximum (random logits hold near-ties)."""
    _, tcfg = _cfgs(name, kv)
    _, params = _weights(name)
    N = CACHE - PROMPT
    prompts = _tokens(name)[:, :PROMPT]
    toks = Engine(params, tcfg, max_seq_len=CACHE, device="cpu").generate(prompts, N).numpy()
    logits, ref_toks = _ref_run(name, kv, toks[:, :N - 1])
    chosen = np.take_along_axis(logits, toks.T[..., None], -1)[..., 0]
    assert (logits.max(-1) - chosen <= LOGIT_TOL).all(), (toks, ref_toks)
    assert (toks == ref_toks).mean() > 0.9, (toks, ref_toks)


def _serve(srv, prompts, budgets, arrivals, priorities=None):
    priorities = priorities or [0] * len(prompts)
    ids = [srv.submit(p, m, arrival_time=a, priority=pr)
           for p, m, a, pr in zip(prompts, budgets, arrivals, priorities)]
    res = srv.run_until_drained()
    return [res[i] for i in ids]


@pytest.mark.parametrize("kv", [16, 4])
def test_server_on_rings_matches_per_request_engine(kv, monkeypatch):
    """danube on a pool of two rings of 16 slots: prompts of 5 to 27 tokens
    (over the ring too) and decodes that cross the window; each prefill at
    the prompt's own length (no bucket), and every request's tokens the
    per-request Engine's; then two priority classes with preemption: a
    wrapped ring spilled and restored, the same tokens."""
    _, tcfg = _cfgs("h2o-danube-3-4b", kv)
    _, params = _weights("h2o-danube-3-4b")
    rs = np.random.RandomState(11)
    lens, budgets = [27, 5, 12, 18, 9], [10, 20, 12, 6, 14]
    prompts = [rs.randint(0, tcfg.vocab_size, L) for L in lens]
    seen = []
    real = lm.backbone_seq
    monkeypatch.setattr(lm, "backbone_seq", lambda p, t, *a, **k: seen.append(t.shape[1])
                        or real(p, t, *a, **k))
    out = _serve(Server(params, tcfg, num_slots=2, max_seq_len=CACHE, device="cpu"),
                 prompts, budgets, [1.0 * i for i in range(5)])
    assert seen == lens
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        ref = Engine(params, tcfg, max_seq_len=CACHE, device="cpu").generate(p[None], m)
        assert out[i] == ref[0].tolist(), i
    srv = Server(params, tcfg, num_slots=2, max_seq_len=CACHE, max_preemptions=2, device="cpu")
    spilled = []
    real_spill = srv.pool.spill_slot
    srv.pool.spill_slot = lambda slot: spilled.append(real_spill(slot)) or spilled[-1]
    sla = _serve(srv, prompts, budgets, [0.0, 0.0, 6.0, 7.0, 8.0], [1, 1, 0, 0, 0])
    assert srv.scheduler.n_preemptions >= 1 and sla == out
    assert any(s["next_pos"] > 16 for s in spilled)   # a ring that had wrapped


def test_spill_of_a_wrapped_ring_restores_bit_exact():
    """A request decoded past its ring's length: its spilled row holds the
    ring as stored (positions out of order), and restoring it into a
    scribbled slot and spilling again gives the same bits, the other row
    untouched."""
    _, tcfg = _cfgs("h2o-danube-3-4b", 4)
    _, params = _weights("h2o-danube-3-4b")
    srv = Server(params, tcfg, num_slots=2, max_seq_len=CACHE, device="cpu")
    prompt = _tokens("h2o-danube-3-4b")[0, :14]
    srv.submit(prompt, 20)
    srv.submit(prompt[:5], 20)
    for _ in range(6):
        srv.step()
    spill = srv.pool.spill_slot(0)
    pos = spill["rows"][0]["pos"]
    assert spill["next_pos"] == 14 + 6 and int(pos.max()) == 19 and int(pos[:, 0].min()) >= 16
    other = {k: v[:, 1].clone() for k, v in srv.pool.caches[0].items()}
    for leaf in srv.pool.caches[0].values():
        leaf[:, 0] = 0
    srv.pool.restore_slot(0, spill)
    again = srv.pool.spill_slot(0)
    for key, row in spill["rows"][0].items():
        assert torch.equal(again["rows"][0][key], row), key
        assert torch.equal(srv.pool.caches[0][key][:, 1], other[key]), key


@pytest.mark.parametrize("name", WINDOWED)
def test_paged_and_chunked_refused_for_windows(name):
    """The reference's refusals, word for word in what they match."""
    _, tcfg = _cfgs(name)
    _, params = _weights(name)
    with pytest.raises(ValueError, match="paged serving requires causal full attention"):
        Server(params, tcfg, num_slots=2, max_seq_len=CACHE, paged=True, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk needs a bucketing-safe arch"):
        Server(params, tcfg, num_slots=2, max_seq_len=CACHE, prefill_chunk=8, device="cpu")
