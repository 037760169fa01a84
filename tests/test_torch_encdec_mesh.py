"""The encoder-decoder on a mesh of ranks, preemption of a sharded slot pool
and the step profiler on a mesh (``models/sharding.py``, ``models/seq2seq.py``,
``serving/kvcache.py``, ``utils/cost.py``), on the CPU.

seamless-m4t-large-v2's ``reduced()`` config (2 encoder and 2 decoder
layers, d 64, 4 q heads over 2 KV heads, vocab 256) and tiny-650k take the
reference's inits, carried across with ``interop``; inputs are numpy draws
from fixed seeds.  Gloo worlds 1x2, 2x1 and 2x2 are spawned at once
(``tests/torch_encdec_mesh_worker.py``, no JAX) beside the reference's own
sharded seq2seq at 2x2 on 4 forced host devices
(``tests/torch_encdec_mesh_reference.py``).  The bars:

* placements, in process: seamless's param placements (dense and 4-bit at
  ``reduced()``; the full-size tree at 1x4, 16x16 and 2x16x16, where its
  256,206-row vocabulary divides none of the model axes and stays whole)
  equal the reference's ``param_spec_tree`` leaf for leaf, and its cache
  placements (self and cross, the cross positions by the same rule as the
  self ones) the reference's ``launch/specs._cache_specs``;
* served: ``prefill`` and 8 teacher-forced ``decode_step``s on every world,
  dense and 4-bit, within ``BF16_BAR`` of the port's unsharded logits and
  (dense) of the reference's unsharded ones, at 2x2 also of the reference's
  sharded rollout; the caches after within it too; a source length that
  does not divide the sequence grid warns and reads locally, within the
  same bar;
* trained: one step's loss within ``LOSS_BAR`` and every gradient leaf
  within ``GRAD_BAR`` of its max |g| of the port's unsharded step and of
  the reference's (at 2x2 also its sharded step), with a batch that divides
  the data ranks and one that does not (whole on every data rank); the
  mesh's state through a collective checkpoint bit for bit;
* preemption: a two-slot Server at kv4 whose victim resumes in the other
  slot, on another data rank where "data" > 1, gives the tokens of the
  sharded Server that preempts nothing bit for bit, and its tokens, the
  unsharded preempted Server's and the sharded batch-1 Engine's are each
  the unsharded greedy choice within ``BF16_BAR`` (teacher-forced: on the
  CPU the splits sum in other orders and near-ties flip, ROADMAP C6; on the
  card chip_smoke holds them equal bit for bit at 1x1); its spill bytes are
  the reference's whole-row count, and the ranks' held bytes sum to it;
* the profiler at 1x2: each rank's dot FLOPs of every program half the
  unsharded program's, and a decode step's ``collective_bytes`` the count
  by hand from the placements under ``utils/hlo.py``'s rule.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import seq2seq as rseq  # noqa: E402
from repro.models import sharding as rsh  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving.kvcache import SlotKVCache as RSlotKVCache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import seq2seq  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from test_torch_sharding import _leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_encdec_mesh_worker.py"
REFERENCE = ROOT / "tests" / "torch_encdec_mesh_reference.py"
SEAMLESS = "seamless-m4t-large-v2"
NO_EXCESS = {"xla_allow_excess_precision": False}
LOSS_BAR, GRAD_BAR, BF16_BAR = 1e-3, 0.05, 0.08
#: served: B sources of S_M frames (S_ODD: a length no grid of 2 divides),
#: a BOS prefix of T_PRE, N teacher-forced steps
B, S_M, S_ODD, T_PRE, N = 4, 16, 15, 2, 8
#: trained: 4 x (32 frames, 16 tokens), the reference's T = max(S // 4, 16);
#: and a batch of 3, which no data axis of 2 divides
TRAIN_B, TRAIN_S, TRAIN_T, ODD_B = 4, 32, 16, 3
#: the preemption trace's and the profiler's cache budget
POOL_S = 32
WORLDS = {"1x2": ["encdec_serve", "encdec_train", "preempt", "profile"],
          "2x1": ["encdec_serve", "encdec_train", "preempt"],
          "2x2": ["encdec_serve", "encdec_train", "preempt"]}


class RefMesh:
    """The reference's view of a mesh: axis names, sizes, size."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)
        self.size = int(np.prod(list(sizes.values())))


class PortMesh:
    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _sharders(rcfg, tcfg, mesh: str):
    r = rsh.Sharder(RefMesh(MESHES[mesh]), rcfg, replicate_params_below=0)
    r._ns = lambda *spec: tuple(spec)
    return r, tsh.Sharder(PortMesh(MESHES[mesh]), tcfg, replicate_params_below=0)


def _cfgs():
    return r_get_arch(SEAMLESS).reduced(), get_arch(SEAMLESS).reduced()


@functools.lru_cache(maxsize=None)
def _raw(quantized: bool = False):
    rcfg, _ = _cfgs()
    raw = jax.jit(lambda k: rseq.init_params(k, rcfg))(jax.random.PRNGKey(0))
    if quantized:
        raw = jax.jit(lambda p: r_quantize_params(
            p, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg))(raw)
    return raw


# -- placements ---------------------------------------------------------------------

@pytest.mark.parametrize("size,quantized,mesh", [
    ("reduced", False, "1x2"), ("reduced", False, "2x2"), ("reduced", True, "1x2"),
    ("reduced", True, "2x2"), ("full", False, "1x4"), ("full", False, "16x16"),
    ("full", False, "2x16x16")])
def test_seamless_param_placements_equal_reference(size, quantized, mesh):
    if size == "reduced":
        rcfg, tcfg = _cfgs()
        raw = _raw(quantized)
        port = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    else:
        rcfg, tcfg = r_get_arch(SEAMLESS), get_arch(SEAMLESS)
        raw = jax.eval_shape(lambda k: rseq.init_params(k, rcfg), jax.random.PRNGKey(0))
        port = seq2seq.init_params(tcfg, device="meta")
    r, t = _sharders(rcfg, tcfg, mesh)
    ref, got = _leaves(r.param_spec_tree(raw)), _leaves(t.param_spec_tree(port))
    assert ref.keys() == got.keys()
    assert got == ref
    assert any(v and "model" in v for v in got.values())
    if size == "full":   # 256,206 rows: the vocabulary stays whole along "model"
        assert got["/embed"][0] is None and got["/lm_head"][0] is None


def _ref_cache_specs(r, rcfg, batch, L, S_d, S):
    """specs._cache_specs of the reference's decode caches (self, (kx,
    vx)) and of a cross position array [L, S] placed by the same rule."""
    K, Dh = rcfg.n_kv_heads, rcfg.head_dim
    sds = jax.ShapeDtypeStruct
    self_c = {"k": sds((L, batch, S_d, K, Dh), jax.numpy.bfloat16),
              "v": sds((L, batch, S_d, K, Dh), jax.numpy.bfloat16),
              "pos": sds((L, S_d), jax.numpy.int32)}
    cross = (sds((L, batch, S, K, Dh), jax.numpy.bfloat16),
             sds((L, batch, S, K, Dh), jax.numpy.bfloat16))
    return rspecs._cache_specs(r, (self_c, cross, sds((L, S), jax.numpy.int32)), batch, rcfg)


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "16x16", "2x16x16"])
def test_seamless_cache_placements_equal_reference(mesh, monkeypatch):
    monkeypatch.setattr(rspecs, "NamedSharding", lambda m, spec: tuple(spec))
    monkeypatch.setattr(rspecs, "P", lambda *spec: spec)
    for rcfg, tcfg in (_cfgs(), (r_get_arch(SEAMLESS), get_arch(SEAMLESS))):
        r, t = _sharders(rcfg, tcfg, mesh)
        L, S_d, K, Dh = tcfg.n_layers, tcfg.decoder_cache_len, tcfg.n_kv_heads, tcfg.head_dim
        for batch in (1, 2, 4, 32):
            for S in (S_M, S_ODD, 1024):
                self_c, cross, pos = _ref_cache_specs(r, rcfg, batch, L, S_d, S)
                kv = lambda n: torch.empty((L, batch, n, K, Dh), device="meta")  # noqa: E731
                caches = ({"k": kv(S_d), "v": kv(S_d), "pos": torch.empty((L, S_d), device="meta")},
                          {"k": kv(S), "v": kv(S), "pos": torch.empty((L, S), device="meta")})
                got = t.cache_spec_tree(caches, batch)
                assert got[0] == self_c
                assert (got[1]["k"], got[1]["v"], got[1]["pos"]) == (*cross, pos)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_seamless_train_state_is_stored_fsdp(mesh):
    """The train placement of seamless's state: the param placements in
    leaves order, every leaf cut over its axes."""
    _, tcfg = _cfgs()
    t = tsh.Sharder(PortMesh(MESHES[mesh]), tcfg, replicate_params_below=0)
    pl = t.train_placement()
    assert pl.on and len(pl.specs) == len(pl.shapes)
    for shape, local, spec in zip(pl.shapes, pl.local_shapes, pl.specs, strict=True):
        n = int(np.prod([t._axis_size(e) for e in spec if e is not None]))
        assert int(np.prod(local)) * n == int(np.prod(shape))
    assert any(local != shape for local, shape in zip(pl.local_shapes, pl.shapes))


# -- the worlds ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    rcfg, _ = _cfgs()
    rs = np.random.RandomState(0)
    D = rcfg.d_model
    tiny = jax.jit(lambda k: rlm.init_params(k, r_get_arch("tiny-650k")))(jax.random.PRNGKey(1))
    t = rs.randint(0, rcfg.vocab_size, (TRAIN_B, TRAIN_T + 1)).astype(np.int32)
    prompt = lambda n: rs.randint(0, 2048, n).astype(np.int64)  # noqa: E731
    return {
        "raw": {"seamless": jax.tree.map(np.asarray, _raw()),
                "tiny": jax.tree.map(np.asarray, tiny)},
        "frames": rs.randn(B, S_M, D).astype(np.float32),
        "frames_odd": rs.randn(B, S_ODD, D).astype(np.float32),
        "bos": np.zeros((B, T_PRE), np.int32),
        "force": rs.randint(0, rcfg.vocab_size, (B, N)).astype(np.int32),
        "train": {"frames": rs.randn(TRAIN_B, TRAIN_S, D).astype(np.float32),
                  "tokens": t[:, :-1], "labels": t[:, 1:]},
        "train_odd": {"frames": rs.randn(ODD_B, TRAIN_S, D).astype(np.float32),
                      "tokens": t[:ODD_B, :-1], "labels": t[:ODD_B, 1:]},
        # two background requests, then an urgent one: the later background
        # request is the victim, and the other one ends first
        "requests": [dict(prompt=prompt(6), max_new=4, arrival_time=0.0, priority=1),
                     dict(prompt=prompt(9), max_new=12, arrival_time=0.0, priority=1),
                     dict(prompt=prompt(5), max_new=8, arrival_time=2.0, priority=0)],
        "prompts": rs.randint(0, 2048, (2, 8)).astype(np.int64),
        "S": POOL_S,
    }


def _ref_rollout(frames):
    """The reference's unsharded teacher-forced rollout (dense)."""
    rcfg, _ = _cfgs()
    inp = _inputs()
    pf = jax.jit(lambda p, f, t: rseq.prefill(p, f, t, rcfg)).lower(
        _raw(), frames, inp["bos"]).compile(compiler_options=NO_EXCESS)
    logits, caches = pf(_raw(), frames, inp["bos"])
    step = jax.jit(lambda p, tok, c, pos: rseq.decode_step(p, tok, c, pos, rcfg))
    step = step.lower(_raw(), inp["force"][:, 0], caches, jax.numpy.int32(T_PRE)).compile(
        compiler_options=NO_EXCESS)
    logs = [np.asarray(logits, np.float32)]
    for t in range(N):
        logits, caches = step(_raw(), inp["force"][:, t], caches, jax.numpy.int32(T_PRE + t))
        logs.append(np.asarray(logits, np.float32))
    return np.stack(logs, 1)


def _ref_grads():
    """(loss, {keystr: gradient}) of the reference's unsharded step."""
    rcfg, _ = _cfgs()
    b = _inputs()["train"]
    f = jax.jit(jax.value_and_grad(lambda p: rseq.loss_fn(
        p, b["frames"], b["tokens"], b["labels"], rcfg, remat=True)),
        compiler_options=NO_EXCESS)
    value, grads = f(_raw())
    return float(value), {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                          for k, v in jax.tree_util.tree_leaves_with_path(grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("encdec_mesh")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {}
    for mesh, checks in WORLDS.items():
        inp, out = d / f"in{mesh}.pkl", d / f"out{mesh}.npz"
        with open(inp, "wb") as f:
            pickle.dump({**_inputs(), "checks": checks, "ckpt": str(d / f"ckpt{mesh}")}, f)
        procs[mesh] = (subprocess.Popen(
            [sys.executable, str(WORKER), "--mesh", mesh, "--inp", str(inp), "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env), out)
    inp, out = d / "ref.pkl", d / "ref.npz"
    with open(inp, "wb") as f:
        pickle.dump({"raw": _inputs()["raw"]["seamless"],
                     **{k: _inputs()[k] for k in ("frames", "bos", "force", "train")}}, f)
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
               "JAX_PLATFORMS": "cpu"}
    procs["ref_2x2"] = (subprocess.Popen(
        [sys.executable, str(REFERENCE), "--mesh", "2x2", "--inp", str(inp), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ref_env), out)
    inp_ = _inputs()
    res = {"ref_even": _ref_rollout(inp_["frames"]), "ref_odd": _ref_rollout(inp_["frames_odd"]),
           "ref_grads": _ref_grads()}
    for key, (proc, out) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{key}: {err[-3000:]}"
        res[key] = dict(np.load(out))
    return res


def _f32(a) -> np.ndarray:
    a = np.asarray(a)
    return (a.astype(np.int32) << 16).view(np.float32) if a.dtype == np.int16 else a


def _gap(a, b) -> float:
    return float(np.abs(_f32(a).astype(np.float64) - _f32(b).astype(np.float64)).max())


def _rel(a, b) -> float:
    return _gap(a, b) / max(float(np.abs(_f32(b)).max()), 1e-30)


# -- served ------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["even", "odd"])
@pytest.mark.parametrize("tree", ["dense", "q4"])
@pytest.mark.parametrize("mesh", sorted(WORLDS))
def test_sharded_prefill_and_decode(runs, mesh, tree, case):
    w, name = runs[mesh], f"serve_{tree}_{case}"
    mine, plain = w[name + "_mesh"], w[name + "_plain"]
    assert mine.shape == (B, N + 1, 256) and np.isfinite(mine).all()
    assert _gap(mine, plain) < BF16_BAR
    assert float(w[name + "_cache_gap"]) < BF16_BAR
    if tree == "dense":
        ref = runs[f"ref_{case}"]
        assert _gap(mine, ref) < _gap(plain, ref) + BF16_BAR
        assert _gap(mine, ref) < BF16_BAR
    # a source no grid of 2 divides falls back to the local read, warning
    grid = 2 if mesh != "2x1" else 1
    want = 1 if case == "odd" and S_ODD % grid else 0
    assert (int(w[name + "_fallbacks"]) >= 1) == bool(want)


def test_sharded_rollout_matches_the_reference_sharded(runs):
    w, ref = runs["2x2"], runs["ref_2x2"]["logits"]
    assert _gap(w["serve_dense_even_mesh"], ref) < BF16_BAR


# -- trained -----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["train", "train_odd"])
@pytest.mark.parametrize("mesh", sorted(WORLDS))
def test_sharded_train_step(runs, mesh, case):
    w = runs[mesh]
    p, m = f"{case}_plain", f"{case}_mesh"
    assert abs(float(w[m + "_loss"]) - float(w[p + "_loss"])) < LOSS_BAR
    grads = [k[len(p):] for k in w if k.startswith(p + "_g")]
    assert len(grads) > 20
    for k in grads:
        assert _rel(w[m + k], w[p + k]) < GRAD_BAR, k
    if case == "train":   # and the reference's unsharded step
        loss, ref = runs["ref_grads"]
        assert abs(float(w[m + "_loss"]) - loss) < LOSS_BAR
        for k, g in ref.items():
            assert _rel(w[f"{m}_g{k}"], g) < GRAD_BAR, k


def test_sharded_train_step_matches_the_reference_sharded(runs):
    """The reference's own 2x2 step is 1.2e-3 off its unsharded loss
    (ROADMAP C7), so the loss is held within that gap plus the bar."""
    w, ref = runs["2x2"], runs["ref_2x2"]
    own = abs(float(ref["loss"]) - runs["ref_grads"][0])
    assert abs(float(w["train_mesh_loss"]) - float(ref["loss"])) < own + LOSS_BAR
    for k in (k for k in ref if k.startswith("g")):
        assert _rel(w[f"train_mesh_{k}"], ref[k]) < GRAD_BAR, k


@pytest.mark.parametrize("mesh", sorted(WORLDS))
def test_collective_checkpoint_round_trip(runs, mesh):
    assert bool(runs[mesh]["ckpt_equal"])


# -- preemption of a sharded pool ---------------------------------------------------

def _whole_row_bytes() -> int:
    """The reference's spill count of one tiny-650k kv4 row of POOL_S slots."""
    rcfg = r_get_arch("tiny-650k").with_kv_quant(4)
    pool = RSlotKVCache(rcfg, 2, POOL_S)
    return pool.spill_slot(pool.alloc())["bytes_packed"]


@pytest.mark.parametrize("mesh", sorted(WORLDS))
def test_preempted_sharded_server(runs, mesh):
    w = runs[mesh]
    n = int(w["preempt_mesh_n"])
    assert n >= 1 and n == int(w["preempt_plain_n"]) and int(w["preempt_mesh_kept_n"]) == 0
    spilled, restored = w["preempt_mesh_spilled"], w["preempt_mesh_restored"]
    assert len(spilled) == len(restored) == n
    data = int(mesh.split("x")[0])
    # the victim comes back in the other slot: another data rank's where
    # "data" splits the two slots
    assert restored[0] != spilled[0]
    if data > 1:
        assert restored[0] // (2 // data) != spilled[0] // (2 // data)
    for i in range(3):
        mine = w[f"preempt_mesh_tokens{i}"]
        # the spill and restore are exact: the sharded run that preempts
        # nothing (the same decode plan) gives the same tokens bit for bit
        assert mine.tolist() == w[f"preempt_mesh_kept_tokens{i}"].tolist(), i
        # and every token, of the preempted sharded and unsharded Servers
        # and of the sharded batch-1 Engine, is the unsharded greedy choice
        # within the bf16 bar (CPU summation orders differ by the split:
        # ROADMAP C6; near-ties a bf16 ulp apart flip)
        for tag in ("mesh", "plain", "engine"):
            assert len(w[f"preempt_{tag}_tokens{i}"]) == len(mine)
            assert float(w[f"preempt_{tag}_margins{i}"].max()) < BF16_BAR, (tag, i)
    row = _whole_row_bytes()
    assert float(w["preempt_mesh_bytes_packed"]) == row * n
    assert float(w["preempt_plain_bytes_packed"]) == row * n
    assert float(w["preempt_mesh_bytes_held"].sum()) == row * n


# -- the profiler on a mesh --------------------------------------------------------

def _decode_collective_bytes(batch: int) -> float:
    """A tiny-650k kv4 decode step's per-rank collective payload at 1x2, by
    hand from the placements: the embedding's rows all-reduced over
    "model" (bf16 [B, D]), each of a layer's seven column-parallel 4-bit
    products gathered ([B, N] bf16), the sequence-sharded read's MAX of m
    and SUM of (l, pv) (f32 [B, H], [B, H] + [B, H, Dh]) and its rows
    gathered over "data" (bf16 [B, H, Dh]), the tied head's columns
    gathered ([B, V] bf16); an all-reduce counted twice."""
    cfg = get_arch("tiny-650k")
    D, F, H, Dh, V = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim, cfg.vocab_size
    n_sum = 3 * H * Dh + D + 2 * F + D     # wq, wk, wv, wo, w_gate, w_up, w_down
    layer = 2 * batch * n_sum + 2 * 4 * batch * H + 2 * 4 * batch * H * (1 + Dh) \
        + 2 * batch * H * Dh
    return 2 * 2 * batch * D + cfg.n_layers * layer + 2 * batch * V


@pytest.mark.parametrize("who", ["engine", "server"])
def test_profiler_on_a_mesh(runs, who):
    w = runs["1x2"]
    assert (w[f"profile_mesh_{who}_tokens"] == w[f"profile_plain_{who}_tokens"]).all()
    pre = f"profile_plain_{who}_"
    names = [k[len(pre):] for k in w
             if k.startswith(pre) and k[len(pre):] not in ("tokens", "summary")]
    assert any(n.startswith("prefill") for n in names) and any("decode" in n for n in names)
    for name in names:
        plain, mine = w[f"profile_plain_{who}_{name}"], w[f"profile_mesh_{who}_{name}"]
        assert mine.shape == (2, 4) and plain[3] == 0.0
        for rank in range(2):
            assert mine[rank, 1] * 2 == plain[1], (name, rank)   # dot FLOPs
            assert mine[rank, 3] > 0.0                           # collective bytes
        if "decode" in name:
            want = _decode_collective_bytes(2)
            assert mine[0, 3] == mine[1, 3] == want, (name, mine[:, 3], want)
    assert "per rank" in str(w[f"profile_mesh_{who}_summary"])
