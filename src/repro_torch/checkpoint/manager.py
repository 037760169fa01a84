"""Fault-tolerant checkpointing — port of ``repro/checkpoint/manager.py``.

* atomic commits: write to a temp dir, fsync, ``os.replace``; a crash
  mid-save can never corrupt the latest checkpoint
* async saves: the caller's tensors are copied to the host at ``save`` and
  a background thread serializes them while the train loop steps on
* keep-last-N pruning, resume-from-latest
* data-iterator state (the next data step) stored WITH the params, so a
  restart is exactly-once over the data stream
* topology-free storage: host numpy keyed by the reference's
  ``jax.tree_util.keystr`` paths (``interop.flatten``: ``.params['stack']``,
  ``.opt.m[...]``), bf16 stored as raw 2-byte void as the reference stores
  it, so each package restores the other's checkpoints
* SIGTERM preemption hook: a final synchronous save on eviction
* a train state on a mesh (``sharder=``, ``models/sharding.TrainPlacement``):
  ``save`` is collective — every rank gathers each leaf whole on the
  calling thread before any writing starts, and rank 0 alone writes, so the files
  are what an unsharded run writes; ``restore`` reads whole leaves and
  cuts this rank's slices
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.interop import flatten
from repro_torch.launch.mesh import world_rank
from repro_torch.tree import leaves, unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)   # a snapshot, also of a CPU tensor
    if t.dtype == torch.bfloat16:   # numpy has no bf16: raw 2-byte void, as npz keeps it
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.require(arr, requirements=("C", "W"))   # a copy only where it is not both
    if arr.dtype.kind == "V":   # bf16 as raw 2-byte void
        return torch.from_numpy(arr.view(np.int16)).view(like.dtype).to(like.device)
    return torch.from_numpy(arr).to(like.dtype).to(like.device)


def _rebuild(template, flat: dict, prefix: str = ""):
    """``template``'s structure with each leaf read from ``flat`` under its
    ``interop.flatten`` key."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, f"{prefix}[{k!r}]") for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), flat, f"{prefix}.{f}")
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, flat, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{prefix}: ckpt {arr.shape} != template {tuple(template.shape)}")
    return _from_numpy(arr, template)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None, *, block=False, sharder=None):
        """Snapshot ``tree`` to the host now and write it (on a thread unless
        ``block``).  With ``sharder`` (a TrainState of this rank's slices)
        every rank must call it: the leaves are gathered whole here, and
        only rank 0 writes."""
        placement = _placement(sharder)
        if placement is not None:
            tree = placement.gather_state(tree)   # collective, on the caller's thread
            if world_rank() != 0:
                return
        flat = {k: _to_numpy(v) for k, v in flatten(tree).items()}  # host snapshot NOW
        meta = {"step": int(step), "extra": extra or {}}
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, flat, meta),
                                            daemon=True)
            self._thread.start()
        else:
            self.wait()
            self._write(step, flat, meta)

    def _write(self, step: int, flat: dict, meta: dict):
        with self._lock:
            final = self.dir / f"step_{step:010d}"
            tmp = self.dir / f".tmp_step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **flat)
            with open(tmp / "meta.json", "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic commit
            self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # -- restore ---------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, *, sharder=None):
        """Returns (step, tree, extra) or None if no checkpoint exists; each
        leaf takes the dtype and device of ``template``'s leaf.  With
        ``sharder``, ``template`` is a TrainState of this rank's slices (or
        of whole leaves), and the tree comes back as this rank's slices of
        the stored whole leaves."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        d = self.dir / f"step_{step:010d}"
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        with open(d / "meta.json") as f:
            meta = json.load(f)
        placement = _placement(sharder)
        if placement is None:
            return meta["step"], _rebuild(template, flat), meta["extra"]
        whole = placement.map_state(template, lambda t: None if t is None else unflatten(
            t, [_Like(n, x) for n, x in zip(placement.shapes, leaves(t), strict=True)]))
        return meta["step"], placement.cut_state(_rebuild(whole, flat)), meta["extra"]


class _Like:
    """A stand-in template leaf: a whole leaf's shape with a slice's dtype
    and device."""

    def __init__(self, shape, like: torch.Tensor):
        self.shape, self.dtype, self.device = tuple(shape), like.dtype, like.device


def _placement(sharder):
    """The train placement of a sharder on a mesh, else None."""
    if sharder is None or sharder.mesh is None:
        return None
    return sharder.train_placement()


def install_preemption_hook(save_fn):
    """On SIGTERM (cluster eviction), run a final synchronous save, then exit
    with 143.  Returns the new handler (``signal.getsignal`` beforehand
    gives the one it replaces)."""

    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
    return handler
