"""Training on a mesh of ranks (``models/sharding.TrainPlacement``,
``train/step.py`` with ``sharder=``, ``launch/elastic.py``), on the CPU:
tiny-650k (4 heads, d 128) on gloo worlds of 4 (2x2, 1x4, 4x1 ("data",
"model") meshes) and 2 (1x2), one batch of 8 x 64 tokens from a numpy seed,
the reference's init carried across with ``interop``.

Each world is spawned once (``tests/torch_train_mesh_worker.py``, no JAX:
one process a rank, one thread each) and runs its checks; the reference's
own sharded step runs on 4 forced host devices in a subprocess
(``tests/torch_train_mesh_reference.py``).  The bars:

* placements (a): the train state's params, AdamW moments and compression
  errors placed leaf for leaf as the reference's ``param_spec_tree`` at
  2x2, 1x2 and 2x1 and on a padded-GQA variant (6 q heads over 3 KV heads),
  each rank storing the whole leaf's bytes over its shard count;
* one step (b): the global loss within 1e-3 of the port's unsharded loss,
  each gradient leaf within 0.05 of that leaf's max |g| of the unsharded
  gradient (bf16 sums in another order; the reference's own sharded step
  is 0.022-0.024 off its unsharded one); (c) the 2x2 gradients within the
  same bar of the reference's sharded step; (d) with label masks that
  differ between data ranks the loss is the global mean (a mean of per-rank
  means is further than the bar on this batch; a gradient scaled by the
  group size fails the bar); (e) 2 microbatches within the bar of 1; (f)
  the global norm of the slices equals the whole tree's (rel 1e-6); (g)
  compression of the slices equals compression of the whole leaves bit
  for bit, two rounds with the error fed back;
* (h) a 2x2 run saves at step 2; restored whole and re-placed on a 1x2
  mesh (``elastic.remesh_state``), and restored unsharded in this process,
  its whole leaves equal the 2x2 state bit for bit, and the run resumed on
  the 1x2 mesh gives the uninterrupted 2x2 run's next losses within 1e-3;
* a world of one rank in this process (gloo, a 1x1 mesh): two sharded
  steps (bf16 masters, 8-bit compression, 2 microbatches, the state
  donated) equal two unsharded ones bit for bit (loss, norm, every leaf of
  the state), and a
  SIGTERM during a sharded run saves collectively and exits 143.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import sharding as rsh  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_train_mesh_worker.py"
REFERENCE = ROOT / "tests" / "torch_train_mesh_reference.py"
ARCH, B, S, LOSS_CHUNK = "tiny-650k", 8, 64, 32
LOSS_BAR, GRAD_BAR = 1e-3, 0.05
#: the padded-GQA variant: 6 q heads over 3 KV heads (head_pad 12 at tp 4)
PAD = dict(n_heads=6, n_kv_heads=3, tie_embeddings=False)
STEP_WORLDS = ["2x2", "1x4", "4x1"]

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _inputs():
    """(the reference's init of tiny-650k as numpy, tokens, labels, labels
    whose masks differ between the data ranks of every world)."""
    rcfg = r_get_arch(ARCH)
    raw = jax.tree.map(np.asarray, jax.jit(lambda k: rlm.init_params(k, rcfg))(
        jax.random.PRNGKey(0)))
    t = np.random.RandomState(0).randint(0, rcfg.vocab_size, (B, S + 1)).astype(np.int32)
    tokens, labels = t[:, :-1], t[:, 1:]
    masked = labels.copy()
    for row, keep in zip(range(4, 8), (4, 2, 3, 1)):   # the last half keeps a few labels
        masked[row, keep:] = -1
    return raw, tokens, labels, masked


def _batch(labels=None):
    _, tokens, lab, _ = _inputs()
    return {"tokens": torch.as_tensor(tokens),
            "labels": torch.as_tensor(lab if labels is None else labels)}


@functools.lru_cache(maxsize=None)
def _unsharded(kind: str = "main"):
    """(loss, {flatten key: gradient}) of the port's unsharded step:
    "main", "masked" (the uneven label masks) or "pad" (the variant at the
    port's init, seed 0)."""
    raw, *_ = _inputs()
    cfg = get_arch(ARCH)
    if kind == "pad":
        cfg = dataclasses.replace(cfg, **PAD)
        from repro_torch.models import lm

        params = lm.init_params(cfg, seed=0, device="cpu")
    else:
        params = interop.params_from_reference(raw, device="cpu")
    batch = _batch(_inputs()[3] if kind == "masked" else None)
    step = tstep.make_train_step(cfg, loss_chunk=LOSS_CHUNK)
    loss, flat = step.grads(params, batch)
    g = interop.flatten(unflatten(params, flat))
    return float(loss), {k: v.numpy() for k, v in g.items()}


#: mesh -> the numbers of its one gloo world
_WORLDS: dict = {}


def _spawn(mesh: str, tmp: Path, **extra) -> dict:
    if mesh not in _WORLDS:
        raw, tokens, labels, masked = _inputs()
        inp, out = tmp / f"in{mesh}.pkl", tmp / f"out{mesh}.npz"
        with open(inp, "wb") as f:
            pickle.dump({"raw": raw, "tokens": tokens, "labels": labels,
                         "masked_labels": masked, "loss_chunk": LOSS_CHUNK, **extra}, f)
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        res = subprocess.run([sys.executable, str(WORKER), "--mesh", mesh, "--inp", str(inp),
                              "--out", str(out)], capture_output=True, text=True, timeout=600,
                             env=env)
        assert res.returncode == 0, res.stderr[-3000:]
        _WORLDS[mesh] = dict(np.load(out))
    return _WORLDS[mesh]


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("train_mesh")


@pytest.fixture(scope="module")
def reference_grads(tmp):
    """The reference's sharded step on a 2x2 mesh of forced host devices,
    started first and read when a test asks (it runs beside the worlds)."""
    raw, tokens, labels, _ = _inputs()
    inp, out = tmp / "ref_in.pkl", tmp / "ref_out.npz"
    with open(inp, "wb") as f:
        pickle.dump({"raw": raw, "tokens": tokens, "labels": labels,
                     "loss_chunk": LOSS_CHUNK}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen([sys.executable, str(REFERENCE), "--mesh", "2x2", "--inp", str(inp),
                             "--out", str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    cache = {}

    def read():
        if not cache:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            cache.update(np.load(out))
        return cache

    yield read
    proc.kill()


@pytest.fixture(scope="module")
def saved(tmp, reference_grads):
    """The 2x2 world: the step checks, then the save-and-resume run's first
    half (a checkpoint at step 2 under tmp/ckpt)."""
    return _spawn("2x2", tmp, save=str(tmp / "ckpt"))


def _four(mesh: str, tmp: Path) -> dict:
    """A world of four ranks other than 2x2 (the 1x4 one also trains the
    padded-GQA variant)."""
    extra = {"variants": {"pad": (PAD, 0)}} if mesh == "1x4" else {}
    return _spawn(mesh, tmp, **extra)


@pytest.fixture(scope="module", params=STEP_WORLDS)
def world(request, tmp, saved):
    """(mesh, numbers) of each world of four ranks."""
    return request.param, saved if request.param == "2x2" else _four(request.param, tmp)


@pytest.fixture(scope="module")
def resumed(tmp, saved):
    """The 1x2 world: the 2x2 checkpoint re-placed and resumed there."""
    return _spawn("1x2", tmp, steps=False, resume=str(tmp / "ckpt"))


def _grads(w, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix + "[")}


def _within(got: dict, want: dict, bar: float = GRAD_BAR) -> float:
    """The worst leaf's gap over its max |g|; asserts the keys match."""
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
               for k in want)


# -- (a) placements --------------------------------------------------------------

class _Mesh:
    """A stand-in mesh: axis names, sizes and this rank's coordinate."""

    def __init__(self, d, m, coord=(0, 0)):
        self.mesh_dim_names = ("data", "model")
        self.shape = (d, m)
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)


class _RefMesh:
    def __init__(self, d, m):
        self.axis_names = ("data", "model")
        self.shape = {"data": d, "model": m}
        self.size = d * m


def _ref_specs(rcfg, d, m) -> list:
    """The reference's ``param_spec_tree`` of its init, leaf by leaf in jax
    order, as tuples."""
    r = rsh.Sharder(_RefMesh(d, m), rcfg, replicate_params_below=0)
    r._ns = lambda *spec: tuple(spec)
    shapes = jax.eval_shape(lambda k: rlm.init_params(k, rcfg), jax.random.PRNGKey(0))
    spec = r.param_spec_tree(shapes)
    return jax.tree_util.tree_leaves(
        spec, is_leaf=lambda x: isinstance(x, tuple) and not (x and isinstance(x[0], dict)))


@pytest.mark.parametrize("variant", ["", "pad"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 1)])
def test_train_state_placed_as_reference_and_stored_in_slices(mesh, variant):
    d, m = mesh
    over = PAD if variant else {}
    rcfg = dataclasses.replace(r_get_arch(ARCH), **over)
    cfg = dataclasses.replace(get_arch(ARCH), **over)
    want = _ref_specs(rcfg, d, m)
    state = tstep.init_state(cfg, device="cpu", grad_compress_bits=8)
    names = list(interop.flatten(state.params))
    for r_d in range(d):
        for r_m in range(m):
            s = tsh.Sharder(_Mesh(d, m, (r_d, r_m)), cfg, replicate_params_below=0)
            pl = s.train_placement()
            assert [tuple(x) for x in pl.specs] == [tuple(x) for x in want], names
            local = s.shard_train_state(state)
            for tree in (local.params, local.opt.m, local.opt.v, local.err):
                for x, whole, spec in zip(leaves(tree), leaves(state.params), pl.specs,
                                          strict=True):
                    shards = 1
                    for e in spec:
                        shards *= s._axis_size(e) if e is not None else 1
                    assert x.numel() * shards == whole.numel()
            assert local.opt.step is state.opt.step
    # a leaf of two split dims is cut over both axes: 1/(data x model) of it
    if mesh == (2, 2) and not variant:
        i = names.index("['stack'][0]['mixer']['wq']['w']")
        assert pl.specs[i] == (None, "data", "model")


# -- (b)-(g) one step on the worlds of four --------------------------------------

def test_sharded_step_matches_unsharded(world):
    mesh, w = world
    loss, grads = _unsharded()
    assert abs(float(w["loss"]) - loss) < LOSS_BAR, (mesh, float(w["loss"]), loss)
    gap = _within(_grads(w, "g"), grads)
    assert gap < GRAD_BAR, (mesh, gap)


def test_sharded_step_matches_reference_sharded_step(saved, reference_grads):
    ref = reference_grads()
    got = _grads(saved, "g")
    assert abs(float(saved["loss"]) - float(ref["loss"])) < LOSS_BAR
    gap = _within(got, {k: v for k, v in ref.items() if k != "loss"})
    assert gap < GRAD_BAR, gap


def test_loss_is_the_global_mean_under_uneven_masks(world):
    mesh, w = world
    loss, grads = _unsharded("masked")
    assert abs(float(w["masked_loss"]) - loss) < LOSS_BAR, (mesh, float(w["masked_loss"]), loss)
    got = _grads(w, "masked_g")
    assert _within(got, grads) < GRAD_BAR
    # the bar tells these apart: a gradient scaled by the group size fails it
    assert _within({k: 2 * v for k, v in got.items()}, grads) > GRAD_BAR
    # and so does a mean of per-rank means, on the data ranks of this world
    d = int(mesh.split("x")[0])
    if d > 1:
        _, tokens, _, masked = _inputs()
        per = [tstep.make_train_step(get_arch(ARCH), loss_chunk=LOSS_CHUNK).grads(
            interop.params_from_reference(_inputs()[0], device="cpu"),
            {"tokens": torch.as_tensor(tokens[i * B // d:(i + 1) * B // d]),
             "labels": torch.as_tensor(masked[i * B // d:(i + 1) * B // d])})[0]
            for i in range(d)]
        assert abs(float(sum(per)) / d - loss) > 5 * LOSS_BAR


def test_microbatches_agree_on_the_mesh(world):
    mesh, w = world
    assert abs(float(w["mb2_loss"]) - float(w["loss"])) < LOSS_BAR
    assert _within(_grads(w, "mb2_g"), _grads(w, "g")) < GRAD_BAR


def test_global_norm_is_the_whole_trees(world):
    _, w = world
    assert abs(float(w["norm"]) - float(w["norm_whole"])) <= 1e-6 * float(w["norm_whole"])


def test_sharded_compression_equals_whole_leaves_bit_for_bit(world):
    _, w = world
    assert w["compress_equal"].tolist() == [True] * 4
    assert int(w["compress_leaves"]) > 0


def test_each_rank_stores_its_share(world):
    """Rank 0's gradient (and so param, moment and error) slices: a leaf
    split over both axes holds 1/(data x model) of its bytes."""
    mesh, w = world
    d, m = (int(p) for p in mesh.split("x"))
    state = tstep.init_state(get_arch(ARCH), device="cpu")
    whole = [x.numel() * 4 for x in leaves(state.params)]
    local = w["local_bytes"].tolist()
    assert sum(local) < sum(whole)
    names = list(interop.flatten(state.params))
    i = names.index("['stack'][0]['ffn']['w_up']['w']")
    assert local[i] * d * m == whole[i]


def test_padded_gqa_variant_trains_on_four_model_ranks(tmp, saved):
    """6 q heads over 3 KV heads on a 4-way model axis: padded to 12 inside
    the KV groups, a rank's 3 heads reading their KV heads by index."""
    w = _four("1x4", tmp)
    assert int(w["pad_head_pad"]) == 12
    loss, grads = _unsharded("pad")
    assert abs(float(w["pad_loss"]) - loss) < LOSS_BAR
    assert _within(_grads(w, "pad_g"), grads) < GRAD_BAR


# -- (h) save, remesh, restore, resume ------------------------------------------

def _state_bits(w, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix + ".")}


def test_save_remesh_restore_bit_for_bit(saved, resumed, tmp):
    want = _state_bits(saved, "state")
    assert want and int(resumed["restored_step"]) == 2
    got = _state_bits(resumed, "remesh")
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # a 1x2 rank holds half of a leaf split over "model" (data is 1 there)
    assert sum(resumed["remesh_local_bytes"]) < sum(
        v.nbytes for k, v in want.items() if k.startswith(".params"))
    # and restored unsharded, in this process
    cfg = get_arch(ARCH)
    step, state, extra = CheckpointManager(tmp / "ckpt").restore(
        tstep.init_state(cfg, device="cpu", grad_compress_bits=8))
    assert step == 2 and extra["data_step"] == 2
    flat = interop.flatten(state)
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        bits = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
        assert np.array_equal(bits, want[k]), k


def test_resumed_on_another_mesh_continues_the_run(saved, resumed, tmp):
    assert str(resumed["resume_log"][0]).startswith("[resume] step 2")
    full, tail = saved["full_losses"], resumed["resume_tail"]
    assert len(tail) == 2 and np.abs(tail - full[2:]).max() < LOSS_BAR, (tail, full)


# -- a world of one rank in this process -----------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_mesh

    init_world("cpu", rank=0, world=1, init_file=str(tmp / "one_rank"))
    try:
        yield make_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_equals_unsharded_bit_for_bit(one_rank):
    """bf16 masters, 8-bit compression, 2 microbatches: two steps on the
    1x1 mesh (every collective a copy or nothing), the state donated, give
    the unsharded functional steps' loss, norm and state bit for bit."""
    cfg = get_arch(ARCH)
    batch = _batch()
    runs = []
    for sharder in (tsh.Sharder(one_rank, cfg, replicate_params_below=0), None):
        state = tstep.init_state(cfg, device="cpu", grad_compress_bits=8,
                                 param_dtype=torch.bfloat16)
        step = tstep.make_train_step(cfg, sharder=sharder, grad_compress_bits=8,
                                     loss_chunk=LOSS_CHUNK, microbatches=2,
                                     donate=sharder is not None)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs.append((metrics, interop.flatten(state)))
    (m1, s1), (m2, s2) = runs
    assert m1 == m2
    assert sorted(s1) == sorted(s2) and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert s1[".params['embed']"].dtype == torch.bfloat16
    assert s1[".opt.m['embed']"].dtype == torch.float32


def test_sigterm_on_a_mesh_saves_collectively_and_exits_143(one_rank, tmp):
    cfg = get_arch("tiny-160k")
    sharder = tsh.Sharder(one_rank, cfg, replicate_params_below=0)
    previous = signal.getsignal(signal.SIGTERM)

    def log(msg):
        if msg.startswith("step     0"):
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as e:
        tloop.train(cfg, steps=5, batch=2, seq_len=16, device="cpu", sharder=sharder,
                    ckpt_dir=str(tmp / "preempt"), log=log, log_every=1)
    assert e.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is previous
    assert CheckpointManager(tmp / "preempt").all_steps() == [1]
