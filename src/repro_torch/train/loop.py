"""Training loop with fault tolerance — port of ``repro/train/loop.py``:
resume-from-latest, async checkpoints with the data state, a SIGTERM
preemption save and a straggler log (per-step wall-clock EWMA; a step over
``straggler_factor`` x the EWMA is logged — on a cluster the signal to
evict a slow host, here only detected and surfaced).

``grad_compress_bits`` k > 0 trains with blockwise k-bit gradient
compression and error feedback (``optim/grad_compress.py``); the error
state is checkpointed with the parameters.

On a mesh (``sharder=``, ``models/sharding.py``) every rank draws the same
global batch from ``synthetic.batches(seed, start_step)`` and the train
step takes its slice, so a resumed or re-meshed run continues the same
stream; the state is stored as this rank's slices, metrics are global and
only rank 0 logs.  Checkpoints are collective and topology-free
(``checkpoint/manager.py``).  There SIGTERM only raises a flag: at the end
of each step the ranks all-reduce it, and all of them save together and
exit 143, so no rank gathers alone or in the middle of a step's
collectives.
"""

from __future__ import annotations

import signal
import threading
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager, install_preemption_hook
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import world_rank
from repro_torch.train import step as step_mod


def train(cfg, *, steps: int, batch: int, seq_len: int, ckpt_dir: str | None = None,
          ckpt_every: int = 100, seed: int = 0, peak_lr: float = 3e-3,
          grad_compress_bits: int = 0, log_every: int = 20, sharder=None,
          straggler_factor: float = 3.0, log=print, device=None):
    """Train a (tiny) model on the synthetic corpus on ``device`` (CUDA by
    default); returns (final state, this call's per-step losses).  With
    ``sharder`` (on a mesh) the state returned is this rank's slices.

    With ``ckpt_dir`` the run resumes from the latest checkpoint there (its
    data stream from the saved step), saves every ``ckpt_every`` steps and
    at the end (blocking), and saves on SIGTERM; the SIGTERM handler it
    replaced is put back when it returns.  Each checkpoint's ``extra`` holds
    ``data_step`` and ``losses``, every step's loss from step 0."""
    dev = resolve_device(device)
    mesh = sharder is not None and sharder.mesh is not None
    if mesh and world_rank() != 0:
        log = lambda *_: None   # noqa: E731  (rank 0 logs)
    state = step_mod.init_state(cfg, seed=seed, device=dev,
                                grad_compress_bits=grad_compress_bits)
    if mesh:
        state = sharder.shard_train_state(state)
    train_step = step_mod.make_train_step(cfg, sharder=sharder, peak_lr=peak_lr,
                                          total_steps=steps,
                                          grad_compress_bits=grad_compress_bits,
                                          loss_chunk=min(512, seq_len))
    start_step, losses, mgr, done = 0, [], None, 0
    hooked, previous_handler, stop = False, None, [False]
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        restored = mgr.restore(state, sharder=sharder)
        if restored is not None:
            start_step, state, extra = restored
            losses = list(extra.get("losses", []))
            log(f"[resume] step {start_step} from {ckpt_dir}")
        done = start_step
        if threading.current_thread() is threading.main_thread():   # signals need it
            hooked, previous_handler = True, signal.getsignal(signal.SIGTERM)
            if mesh:
                signal.signal(signal.SIGTERM, lambda *_: stop.__setitem__(0, True))
            else:
                # the state and step of the last finished step, read when it fires
                install_preemption_hook(lambda: mgr.save(
                    done, state, extra={"data_step": done, "losses": list(losses)},
                    block=True))
    try:
        data = synthetic.batches(cfg.vocab_size, batch, seq_len, seed=seed,
                                 start_step=start_step, device=dev)
        ewma = None
        history = []
        for i, b in zip(range(start_step, steps), data):
            t0 = time.perf_counter()
            state, metrics = train_step(state, b)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > straggler_factor * ewma and i > start_step + 3:
                log(f"[straggler] step {i} took {dt:.2f}s (ewma {ewma:.2f}s)")
            if i % log_every == 0 or i == steps - 1:
                log(f"step {i:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            history.append(loss)
            losses.append(loss)
            done = i + 1
            if mgr and hooked and mesh and _preempted(stop, sharder, dev):
                mgr.save(done, state, extra={"data_step": done, "losses": list(losses)},
                         block=True, sharder=sharder)
                raise SystemExit(143)
            if mgr and done % ckpt_every == 0:
                mgr.save(done, state, extra={"data_step": done, "losses": list(losses)},
                         sharder=sharder)
        if mgr:
            mgr.save(steps, state, extra={"data_step": steps, "losses": list(losses)},
                     block=True, sharder=sharder)
    finally:
        if hooked:
            signal.signal(signal.SIGTERM, previous_handler if previous_handler is not None
                          else signal.SIG_DFL)
    return state, history


def _preempted(stop, sharder, dev) -> bool:
    """Whether any rank of the world has had a SIGTERM (one all-reduce)."""
    flag = torch.tensor([1.0 if stop[0] else 0.0], device=dev)
    return bool(ops.all_reduce(flag, sharder.group(sharder.axis_names), op="max").item())
