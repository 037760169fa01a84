"""The port's checkpoint manager, resumable train loop, the tiny ladder's
checkpoint cache and the train launcher, against the JAX package's.

The bars: a checkpoint round-trips bit for bit (bf16 included, stored as
the reference stores it, raw 2-byte void), in either direction between the
two packages, under the reference's ``jax.tree_util.keystr`` keys; pruning
keeps the last N, a commit leaves no temp dir, a shape mismatch raises; a
port run resumed at step k gives the uninterrupted run's losses and final
state bit for bit; ``trained_family`` restores a cached ladder bit for bit
with its loss history and never hands a model trained with another recipe;
the SIGTERM hook saves and exits 143, and the train loop puts back the
handler it replaced.
"""

import shutil
import signal
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RCheckpointManager  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, install_preemption_hook  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(2)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_trees(a, b) -> bool:
    fa, fb = interop.flatten(a), interop.flatten(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and tuple(fa[k].shape) == tuple(fb[k].shape)
        and np.array_equal(_bits(fa[k]), _bits(fb[k])) for k in fa)


def _tree():
    return {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
                  "n": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.zeros(3, dtype=torch.float32)]}


def test_checkpoint_roundtrip_and_prune(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, {**_tree(), "a": _tree()["a"] * s})
    assert mgr.all_steps() == [2, 3]  # pruned to keep=2
    step, restored, extra = mgr.restore(_tree())
    assert step == 3 and extra == {}
    assert torch.equal(restored["a"], _tree()["a"] * 3)
    assert restored["b"]["c"].dtype == torch.bfloat16 and restored["b"]["n"].shape == ()
    assert _same_trees(restored["b"], _tree()["b"])
    with pytest.raises(FileNotFoundError):   # step 1 was pruned
        mgr.restore(_tree(), step=1)


def test_checkpoint_async_save_and_extra(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(5, t, extra={"data_step": 5, "losses": [1.0, 0.5]})
    t["a"] += 100.0   # the snapshot was taken at save
    mgr.wait()
    step, restored, extra = mgr.restore(_tree())
    assert step == 5 and extra == {"data_step": 5, "losses": [1.0, 0.5]}
    assert torch.equal(restored["a"], _tree()["a"])


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(7, {"a": torch.zeros(1000)})
    names = [p.name for p in Path(tmp_path).iterdir()]
    assert names == ["step_0000000007"]
    assert CheckpointManager(tmp_path / "empty").restore({"a": torch.zeros(1)}) is None


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros(5)})
    with pytest.raises(KeyError):
        mgr.restore({"b": torch.zeros(4)})


def _reference_state():
    """tiny-160k's reference TrainState with seeded nonzero moments and step."""
    cfg = r_get_arch("tiny-160k")
    st = rstep.init_state(jax.random.PRNGKey(4), cfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(5), 1000))
    noisy = lambda t: jax.tree.map(lambda a: jax.random.normal(next(keys), a.shape), t)  # noqa: E731
    return st._replace(opt=st.opt._replace(step=jnp.asarray(17, jnp.int32), m=noisy(st.opt.m),
                                           v=noisy(st.opt.v)))


def test_reference_train_state_restored_bit_for_bit(tmp_path):
    """A reference checkpoint of tiny-160k's TrainState into the port's
    template, and the port's own checkpoint back into the reference's."""
    rstate = _reference_state()
    RCheckpointManager(tmp_path / "ref", async_save=False).save(17, rstate, extra={"x": 1})
    template = tstep.init_state(get_arch("tiny-160k"), device="cpu")
    step, tstate, extra = CheckpointManager(tmp_path / "ref").restore(template)
    assert (step, extra) == (17, {"x": 1})
    carried = interop.params_from_reference(
        {"params": jax.tree.map(np.asarray, rstate.params),
         "opt": {"step": np.asarray(rstate.opt.step),
                 "m": jax.tree.map(np.asarray, rstate.opt.m),
                 "v": jax.tree.map(np.asarray, rstate.opt.v)}}, device="cpu")
    assert _same_trees(tstate.params, carried["params"])
    assert _same_trees({"step": tstate.opt.step, "m": tstate.opt.m, "v": tstate.opt.v},
                       carried["opt"])
    # and back: the reference restores the port's checkpoint
    CheckpointManager(tmp_path / "port", async_save=False).save(17, tstate)
    _, back, _ = RCheckpointManager(tmp_path / "port").restore(rstate)
    same = jax.tree.map(lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
                        back, rstate)
    assert all(jax.tree.leaves(same))
    # bf16 both ways (stored as raw 2-byte void)
    bf = {"w": torch.linspace(-1, 1, 12, dtype=torch.float32).to(torch.bfloat16).reshape(3, 4)}
    CheckpointManager(tmp_path / "bf", async_save=False).save(1, bf)
    _, rbf, _ = RCheckpointManager(tmp_path / "bf").restore({"w": jnp.zeros((3, 4), jnp.bfloat16)})
    assert rbf["w"].dtype == jnp.bfloat16 and np.array_equal(_bits(rbf["w"]), _bits(bf["w"]))


def test_resumed_run_gives_the_uninterrupted_losses(tmp_path):
    cfg = get_arch("tiny-160k")
    kw = dict(steps=6, batch=2, seq_len=16, device="cpu", log=lambda *_: None)
    full_state, full = tloop.train(cfg, **kw)
    tloop.train(cfg, ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    assert CheckpointManager(tmp_path).all_steps() == [4, 6]
    _, _, extra = CheckpointManager(tmp_path).restore(tstep.init_state(cfg, device="cpu"))
    assert extra["losses"] == full and extra["data_step"] == 6
    shutil.rmtree(tmp_path / "step_0000000006")   # as if preempted after step 4
    logs = []
    state, tail = tloop.train(cfg, ckpt_dir=str(tmp_path), ckpt_every=4,
                              **{**kw, "log": logs.append})
    assert logs[0] == f"[resume] step 4 from {tmp_path}"
    assert tail == full[4:]
    assert _same_trees(state, full_state)


def test_preemption_hook_saves_and_loop_restores_handler(tmp_path):
    previous = signal.getsignal(signal.SIGTERM)
    saved = []
    try:
        handler = install_preemption_hook(lambda: saved.append(True))
        assert signal.getsignal(signal.SIGTERM) is handler
        with pytest.raises(SystemExit) as exc:
            handler(signal.SIGTERM, None)
        assert exc.value.code == 143 and saved == [True]
    finally:
        signal.signal(signal.SIGTERM, previous)
    tloop.train(get_arch("tiny-160k"), steps=1, batch=2, seq_len=16, device="cpu",
                log=lambda *_: None, ckpt_dir=str(tmp_path))
    assert signal.getsignal(signal.SIGTERM) is previous


def test_trained_family_cache_round_trip(tmp_path):
    logs = []
    first = tcommon.trained_family(["tiny-160k"], log=logs.append, device="cpu", steps=3,
                                   cache_dir=tmp_path)
    second = tcommon.trained_family(["tiny-160k"], log=logs.append, device="cpu", steps=3,
                                    cache_dir=tmp_path)
    assert logs[0].startswith("[train] tiny-160k") and logs[1].startswith("[cache] tiny-160k")
    a, b = first["tiny-160k"], second["tiny-160k"]
    assert _same_trees(a.params, b.params) and a.history == b.history and len(a.history) == 3
    # another recipe is another cache entry: never the 3-step model
    tcommon.trained_family(["tiny-160k"], log=logs.append, device="cpu", steps=4,
                           cache_dir=tmp_path)
    assert logs[2].startswith("[train] tiny-160k")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "tiny-160k-s3-b32-l128-cpu", "tiny-160k-s4-b32-l128-cpu"]


def test_launch_train_resumes_from_ckpt_dir(tmp_path, capsys):
    args = ["--arch", "tiny-160k", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    tlaunch.main(args + ["--steps", "2"])
    tlaunch.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[resume] step 2" in out and out.count("done: loss") == 2
    assert CheckpointManager(tmp_path).all_steps() == [2, 4]


@pytest.mark.parametrize("extra", [["--mesh", "pod16x16"], ["--mesh", "pod2x16x16"]])
def test_launch_train_refuses_a11(extra):
    """The production meshes train on a mesh (the sharded train step, A11.2;
    tests/test_torch_train_mesh.py runs it on gloo worlds); in a world of
    one rank the launcher refuses before starting one, naming the 256 or
    512 ranks the mesh needs."""
    ranks = 512 if extra[1] == "pod2x16x16" else 256
    with pytest.raises(ValueError, match=f"needs a world of {ranks} ranks") as e:
        tlaunch.main(["--arch", "tiny-160k", "--steps", "1", "--device", "cpu"] + extra)
    assert "has 1" in str(e.value)

