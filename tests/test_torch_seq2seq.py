"""The port's encoder-decoder with frame inputs (``models/seq2seq.py``, and
the seq2seq path through lm, quantize and the train step) against the JAX
package, on the CPU.

Weights come from the reference's ``seq2seq.init_params(PRNGKey(0))`` at
``reduced()`` (2 encoder and 2 decoder layers, d 64, 4 heads over 2 KV
heads, so GQA in the cross-attention too, vocab 256, ``decoder_cache_len``
32) and are carried across with ``interop.params_from_reference``; frames
and tokens are numpy draws from fixed seeds.  The reference is compiled
once a shape without XLA's excess precision.  The bars:

* configs: the seamless config field for field the reference's (less
  ``kv_use_kernel``), ``count_params`` at full size (2,035,957,760) and at
  ``reduced()`` equal to the reference's, and every reference arch served;
* ``encode``: the memory within one bf16 ulp of its largest value (2^-7 of
  it) of the reference's, dense and 4-bit;
* ``decoder_seq`` + ``logits_from_hidden`` within 0.08 of the reference's
  (the decode-consistency bar of tests/test_decode_consistency.py), dense
  and 4-bit;
* ``prefill`` then 4 ``decode_step``s within 0.08 of the reference's at
  both matmul modes; the cross K/V within a bf16 ulp of the reference's
  largest value, the self cache the reference's layout (bf16 at
  ``decoder_cache_len``) even with ``kv_bits`` 4 or 8 set; the port's own
  decode-vs-full gap under the reference's 0.05
  (``test_seq2seq_prefill_decode_matches_full``);
* the 4-bit tree bit for bit the reference's ``quantize_params`` (codes,
  words, scale bits), unit names, kinds and shapes ``quantizable_units``',
  and with ``outlier_pct=0.02`` the same outlier indices (``frame_proj``
  among the residual consumers);
* ``loss_fn`` within 1e-3 relative of the reference's; one train step on a
  frames batch gives a finite loss and moves the parameters;
* the decoder-only path refuses the arch: ``lm.init_params``, the Engine,
  the Server and ``launch/serve.py`` raise naming ``models/seq2seq.py``
  before anything is built.
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
from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import seq2seq as rseq  # noqa: E402
from repro.models.quantize import quantizable_units as r_units  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.core.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import lm, seq2seq  # noqa: E402
from repro_torch.models.quantize import quantizable_units, quantize_params  # noqa: E402
from repro_torch.serving import Engine, Server  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
NO_EXCESS = {"xla_allow_excess_precision": False}
LOGIT_TOL = 0.08                 # tests/test_decode_consistency.py
FULL_GAP_TOL = 0.05              # test_seq2seq_prefill_decode_matches_full
ULP_OF_MAX = 2.0 ** -7           # one bf16 ulp at the largest value
LOSS_REL = 1e-3
BASE = dict(bits=4, dtype="float", block_size=64)
#: the reference test's shapes: 2 sources of 16 frames, 12 decoder tokens,
#: a prefix of 8
B, S_SRC, T, T_PRE = 2, 16, 12, 8
#: the refusal's pointer
ENTRY = "models/seq2seq.py"


def _cfgs(kv=16):
    return r_get_arch(ARCH).reduced().with_kv_quant(kv), get_arch(ARCH).reduced().with_kv_quant(kv)


def _jit(f, *args):
    """f compiled without XLA's excess precision, called on args."""
    return jax.jit(f).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    t = np.asarray(t)
    return t.view(np.int16) if t.dtype.name == "bfloat16" else t.view(np.int32) \
        if t.dtype == np.uint32 else t


@functools.lru_cache(maxsize=None)
def _weights(quantized: bool):
    """(reference tree, port tree): the reference's PRNGKey(0) init, raw or
    quantized to 4 bits by each package's own quantize_params."""
    rcfg, tcfg = _cfgs()
    raw = jax.jit(lambda k: rseq.init_params(k, rcfg))(jax.random.PRNGKey(0))
    params = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    if not quantized:
        return raw, params
    rq = jax.jit(lambda p: r_quantize_params(p, RQuantConfig(**BASE), rcfg))(raw)
    return rq, quantize_params(params, QuantConfig(**BASE), tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _inputs():
    """frames [B, S_SRC, D] f32 and tokens [B, T] int32 from fixed seeds."""
    rcfg, _ = _cfgs()
    frames = np.random.RandomState(1).randn(B, S_SRC, rcfg.d_model).astype(np.float32)
    toks = np.random.RandomState(2).randint(0, rcfg.vocab_size, (B, T)).astype(np.int32)
    return frames, toks


def _t(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)


# -------------------------------------------------------------------------
# configs and the registry
# -------------------------------------------------------------------------

def test_config_and_counts_equal_reference():
    ref, mine = r_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(mine) == {k: v for k, v in dataclasses.asdict(ref).items()
                                        if k != "kv_use_kernel"}
    assert lm.count_params(mine) == rlm.count_params(ref) == 2_035_957_760
    assert lm.count_params(mine.reduced()) == rlm.count_params(ref.reduced())


@pytest.mark.parametrize("name", ASSIGNED)
def test_every_reference_arch_is_served(name):
    """The registry holds every arch of the reference's, seamless last."""
    assert get_arch(name).name == name


def test_tree_keys_and_layout_equal_reference():
    """The port's own init has the reference's keys, shapes and dtypes, the
    stacks dicts of leaves with a leading layer axis."""
    rcfg, tcfg = _cfgs()
    ref = jax.eval_shape(lambda: rseq.init_params(jax.random.PRNGKey(0), rcfg))
    mine = interop.flatten(seq2seq.init_params(tcfg, seed=0, device="cpu"))
    ref = {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    assert set(mine) == set(ref)
    for key, leaf in ref.items():
        assert tuple(mine[key].shape) == tuple(leaf.shape), key
        assert str(mine[key].dtype).removeprefix("torch.") == str(leaf.dtype), key
    assert mine["['enc_stack']['mixer']['wq']['w']"].shape[0] == tcfg.n_encoder_layers
    assert mine["['dec_stack']['cross_attn']['wk']['w']"].shape[0] == tcfg.n_layers


# -------------------------------------------------------------------------
# the encoder and the decoder
# -------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "4bit"])
def test_encode_matches_reference(quantized):
    rcfg, tcfg = _cfgs()
    rp, tp = _weights(quantized)
    frames, _ = _inputs()
    ref = _np(_jit(lambda p, f: rseq.encode(p, f, rcfg), rp, jnp.asarray(frames)))
    with torch.inference_mode():
        mine = seq2seq.encode(tp, _t(frames), tcfg)
    assert mine.dtype == torch.bfloat16 and tuple(mine.shape) == ref.shape
    gap = float(np.abs(ref - _np(mine)).max())
    assert gap <= ULP_OF_MAX * float(np.abs(ref).max()), gap


@functools.lru_cache(maxsize=None)
def _ref_full_logits(quantized: bool):
    rcfg, _ = _cfgs()
    rp, _ = _weights(quantized)
    frames, toks = _inputs()

    def full(p, f, t):
        h, _ = rseq.decoder_seq(p, t, rseq.encode(p, f, rcfg), rcfg)
        return rseq.logits_from_hidden(p, h, rcfg)

    return _np(_jit(full, rp, jnp.asarray(frames), jnp.asarray(toks)))


def _port_full_logits(quantized: bool, tcfg):
    _, tp = _weights(quantized)
    frames, toks = _inputs()
    with torch.inference_mode():
        h, caches = seq2seq.decoder_seq(tp, _t(toks), seq2seq.encode(tp, _t(frames), tcfg), tcfg)
        assert caches is None
        return _np(lm.logits_from_hidden(tp, h, tcfg))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "4bit"])
def test_decoder_seq_logits_match_reference(quantized):
    _, tcfg = _cfgs()
    gap = float(np.abs(_ref_full_logits(quantized) - _port_full_logits(quantized, tcfg)).max())
    assert gap < LOGIT_TOL, gap


# -------------------------------------------------------------------------
# prefill and decode
# -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_decode(kv: int):
    """The reference's prefill over the first T_PRE tokens, then a decode
    step at each later position, 4-bit weights: (logits a step, the
    prefill's caches)."""
    rcfg, _ = _cfgs(kv)
    rq, _ = _weights(True)
    frames, toks = _inputs()
    logits, caches = _jit(lambda p, f, t: rseq.prefill(p, f, t, rcfg), rq, jnp.asarray(frames),
                          jnp.asarray(toks[:, :T_PRE]))
    first = caches
    step = jax.jit(lambda p, t, c, pos: rseq.decode_step(p, t, c, pos, rcfg)).lower(
        rq, jnp.asarray(toks[:, T_PRE]), caches, jnp.int32(T_PRE)).compile(
        compiler_options=NO_EXCESS)
    out = [_np(logits)]
    for t in range(T_PRE, T):
        logits, caches = step(rq, jnp.asarray(toks[:, t]), caches, jnp.int32(t))
        out.append(_np(logits))
    return np.stack(out), first


def _port_decode(tcfg, quantized=True, pos_as_tensor=False):
    _, tp = _weights(quantized)
    frames, toks = _inputs()
    with torch.inference_mode():
        logits, caches = seq2seq.prefill(tp, _t(frames), _t(toks[:, :T_PRE]), tcfg)
        first = tuple({k: v.clone() for k, v in c.items()} for c in caches)
        out = [_np(logits)]
        for t in range(T_PRE, T):
            pos = torch.tensor(t, dtype=torch.int32) if pos_as_tensor else t
            logits, caches = seq2seq.decode_step(tp, _t(toks[:, t]), caches, pos, tcfg)
            out.append(_np(logits))
    return np.stack(out), first, caches


@pytest.mark.parametrize("mode", ["fused", "dequant_einsum"])
def test_prefill_and_decode_match_reference(mode):
    """A prefill of 8 tokens over 16 frames, then 4 decode steps fed the same
    tokens in both packages, 4-bit weights: every step within 0.08."""
    _, tcfg = _cfgs()
    ref, _ = _ref_decode(16)
    mine, _, _ = _port_decode(tcfg.with_matmul_mode(mode), pos_as_tensor=mode == "fused")
    gap = float(np.abs(ref - mine).max())
    assert gap < LOGIT_TOL, gap


@pytest.mark.parametrize("kv", [16, 8, 4])
def test_caches_match_reference(kv):
    """The prefill's caches: the cross K/V (the reference's (kx, vx), stacked
    over layers) within a bf16 ulp of their largest value, every source
    position held; the self cache bf16 at decoder_cache_len whatever kv_bits
    says (the reference never reads it), its K/V within a bf16 ulp of the
    reference's and its positions the reference's."""
    rcfg, tcfg = _cfgs(kv)
    _, (rself, (rkx, rvx)) = _ref_decode(kv)
    _, (tself, tcross), after = _port_decode(tcfg)
    assert set(tself) == set(rself) == {"k", "v", "pos"}
    for key in ("k", "v"):
        assert tself[key].dtype == torch.bfloat16
        assert tuple(tself[key].shape) == tuple(rself[key].shape) == (
            tcfg.n_layers, B, tcfg.decoder_cache_len, tcfg.n_kv_heads, tcfg.head_dim)
        ref = _np(rself[key])
        assert float(np.abs(ref - _np(tself[key])).max()) <= ULP_OF_MAX * np.abs(ref).max()
    assert np.array_equal(np.asarray(rself["pos"]), tself["pos"].numpy())
    for ref, mine in ((rkx, tcross["k"]), (rvx, tcross["v"])):
        ref = _np(ref)
        assert mine.dtype == torch.bfloat16 and tuple(mine.shape) == ref.shape
        assert float(np.abs(ref - _np(mine)).max()) <= ULP_OF_MAX * np.abs(ref).max()
    assert torch.equal(tcross["pos"], torch.arange(S_SRC, dtype=torch.int32).expand(
        tcfg.n_layers, S_SRC))
    # the decode steps wrote positions T_PRE .. T-1 in place, the rest empty
    want = np.where(np.arange(tcfg.decoder_cache_len) < T, np.arange(tcfg.decoder_cache_len), -1)
    assert np.array_equal(after[0]["pos"].numpy(), np.broadcast_to(want, after[0]["pos"].shape))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "4bit"])
def test_decode_matches_full_forward(quantized):
    """The reference's test_seq2seq_prefill_decode_matches_full on the
    port: the prefill's and every decode step's logits within 0.05 of the
    full decoder's at the same positions."""
    _, tcfg = _cfgs()
    full = _port_full_logits(quantized, tcfg)
    steps, _, _ = _port_decode(tcfg, quantized)
    gap = float(np.abs(steps - full[:, T_PRE - 1:].transpose(1, 0, 2)).max())
    assert gap < FULL_GAP_TOL, gap


# -------------------------------------------------------------------------
# the quantized tree
# -------------------------------------------------------------------------

def test_quantized_tree_bit_exact_to_reference():
    """Every leaf of the 4-bit tree bit for bit: frame_proj, each stacked
    matrix of both stacks (one item a layer) and the untied lm_head
    quantized; embed, the norms and their biases as they were."""
    rq, tq = _weights(True)
    carried = interop.flatten(interop.params_from_reference(jax.tree.map(np.asarray, rq),
                                                            device="cpu"))
    own = interop.flatten(tq)
    assert set(own) == set(carried)
    for key, a in carried.items():
        assert a.dtype == own[key].dtype and np.array_equal(_bits(a), _bits(own[key])), key
    assert isinstance(tq["frame_proj"]["w"], QuantizedTensor)
    assert isinstance(tq["lm_head"], QuantizedTensor)
    assert isinstance(tq["dec_stack"]["cross_attn"]["wk"]["w"], QuantizedTensor)
    assert tq["enc_stack"]["ffn"]["w_down"]["w"].packed.shape[0] == 2
    assert isinstance(tq["embed"], torch.Tensor)


@pytest.mark.parametrize("pct", [0.0, 0.02])
def test_units_match_reference(pct):
    """Unit names, kinds, shapes and proxy outlier index sets; frame_proj
    consumes the residual stream (the model-wide outlier set)."""
    rcfg, tcfg = _cfgs()
    raw, params = _weights(False)
    ref = r_units(raw, rcfg, RQuantConfig(**BASE, outlier_pct=pct))
    mine = quantizable_units(params, tcfg, QuantConfig(**BASE, outlier_pct=pct))
    assert list(mine) == list(ref)
    for name in ("frame_proj", "enc_stack/mixer/wq", "dec_stack/cross_attn/wk",
                 "dec_stack/self_attn/wo", "dec_stack/ffn/w_down", "lm_head"):
        assert name in mine, name
    for u, r in ref.items():
        m = mine[u]
        assert (m["kind"], m["n_params"], m["shape"]) == (r["kind"], r["n_params"], r["shape"])
        if r["outlier_idx"] is None:
            assert m["outlier_idx"] is None, u
        else:
            assert np.array_equal(m["outlier_idx"].numpy(), np.asarray(r["outlier_idx"])), u
    if pct:
        j_res = mine["enc_stack/mixer/wq"]["outlier_idx"][0]
        assert np.array_equal(mine["frame_proj"]["outlier_idx"].numpy(), j_res.numpy())


# -------------------------------------------------------------------------
# loss and training
# -------------------------------------------------------------------------

def _labels(toks):
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    return labels


def test_loss_matches_reference():
    rcfg, tcfg = _cfgs()
    rp, tp = _weights(False)
    frames, toks = _inputs()
    labels = _labels(toks)
    ref = float(_jit(lambda p, f, t, y: rseq.loss_fn(p, f, t, y, rcfg), rp, jnp.asarray(frames),
                     jnp.asarray(toks), jnp.asarray(labels)))
    with torch.inference_mode():
        mine = float(seq2seq.loss_fn(tp, _t(frames), _t(toks), _t(labels), tcfg))
    assert abs(mine - ref) <= LOSS_REL * abs(ref), (mine, ref)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_on_frames_moves_params(microbatches):
    """init_state and make_train_step dispatch on encoder_decoder: one step
    on a {"frames", "tokens", "labels"} batch gives a finite loss (the
    loss_fn of the initial parameters, averaged over the microbatches, as
    the reference's accumulation does) and moves every stack."""
    _, tcfg = _cfgs()
    frames, toks = _inputs()
    state = step_mod.init_state(tcfg, seed=0, device="cpu")
    assert set(state.params) == {"frame_proj", "enc_stack", "enc_final_norm", "embed",
                                 "dec_stack", "final_norm", "lm_head"}
    batch = {"frames": _t(frames), "tokens": _t(toks), "labels": _t(_labels(toks)), "step": 0}
    with torch.no_grad():
        want = np.mean([float(seq2seq.loss_fn(state.params, f, t, y, tcfg)) for f, t, y in zip(
            *(batch[k].chunk(microbatches) for k in ("frames", "tokens", "labels")))])
    before = {k: v.clone() for k, v in interop.flatten(state.params).items()}
    new, metrics = step_mod.make_train_step(tcfg, microbatches=microbatches)(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and abs(loss - want) <= 1e-3 * abs(want), (loss, want)
    after = interop.flatten(new.params)
    for key in ("['frame_proj']['w']", "['enc_stack']['mixer']['wq']['w']",
                "['dec_stack']['cross_attn']['wv']['w']", "['lm_head']"):
        assert not torch.equal(before[key], after[key]), key


# -------------------------------------------------------------------------
# the decoder-only path refuses the arch
# -------------------------------------------------------------------------

def test_decoder_only_init_refuses_naming_seq2seq():
    with pytest.raises(NotImplementedError, match=ENTRY):
        lm.init_params(get_arch(ARCH).reduced(), device="cpu")


@pytest.mark.parametrize("front", ["engine", "server"])
def test_engine_and_server_refuse_before_any_work(front):
    """Refused at construction, before the params are looked at: a tree of
    the wrong shape (None) would fail later."""
    cfg = get_arch(ARCH).reduced()
    with pytest.raises(NotImplementedError, match=ENTRY):
        if front == "engine":
            Engine(None, cfg, max_seq_len=32, device="cpu")
        else:
            Server(None, cfg, num_slots=2, max_seq_len=32, device="cpu")


def test_launcher_refuses_before_building(monkeypatch):
    def built(*a, **k):
        raise AssertionError("the launcher built a model")

    monkeypatch.setattr(serve_mod.lm, "init_params", built)
    with pytest.raises(NotImplementedError, match=ENTRY):
        serve_mod.main(["--arch", ARCH, "--device", "cpu", "--num-requests", "1"])
