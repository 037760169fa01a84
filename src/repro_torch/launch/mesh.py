"""The process world and its device mesh — port of ``repro/launch/mesh.py``.

The reference builds a ``jax.make_mesh`` over the devices of one process.
Here every mesh position is a process: ``init_world`` starts the
``torch.distributed`` process group (``nccl`` on CUDA, one card a process;
``gloo`` on the CPU), and ``make_mesh`` lays that world out as a
``DeviceMesh`` named ("data", "model").  A world comes from torchrun's
environment::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch tiny-650k --mesh 1x2 --kv-bits 4 --device cpu

or, in tests and single-process scripts, from an explicit rank, world size
and rendezvous file (``init_world("cpu", rank=r, world=n,
init_file=path)``; a ``file://`` rendezvous needs no port).  Nothing here
runs when the module is imported.

Peak rates for a roofline are the H100's (``repro_torch/device.py``), not
the TPU v5e constants of the reference's module; ``NET_BW``, the collective
term's, stands where the reference's ``ICI_BW`` does.
"""

from __future__ import annotations

import os

import torch

from repro_torch.device import HBM_BW, NET_BW, PEAK_FLOPS_BF16  # noqa: F401  (re-exported)

#: the two axes of a serving mesh, in the reference's order
AXES = ("data", "model")


def init_world(device: str = "cuda", *, rank: int | None = None, world: int | None = None,
               init_file: str | None = None) -> torch.device:
    """Join (or start) the process group and return this rank's device.

    Without ``rank``/``world`` they come from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK and its rendezvous); with them, ``init_file``
    names the ``file://`` rendezvous every rank of the world shares.  The
    backend is ``nccl`` for ``cuda`` (rank r takes ``cuda:LOCAL_RANK``) and
    ``gloo`` for ``cpu``.  A second call in a process that has a group
    returns the device without starting another."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"init_world runs on cuda or cpu, not {device!r}")
    local = int(os.environ.get("LOCAL_RANK", 0 if rank is None else rank))
    dev = torch.device("cuda", local) if kind == "cuda" else torch.device("cpu")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world('cuda') needs a CUDA device")
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if kind == "cuda" else "gloo"
    if rank is None:
        dist.init_process_group(backend)
    else:
        if world is None or init_file is None:
            raise ValueError("an explicit rank needs world= and init_file=")
        dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}",
                                rank=rank, world_size=world)
    return dev


def make_mesh(data: int, model: int, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` of data x model ranks over the
    process group; raises, naming the world size, when they differ."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_world first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks but the world "
                         f"has {world}")
    return init_device_mesh(torch.device(device).type, (data, model), mesh_dim_names=AXES)


def production_world(*, multi_pod: bool = False) -> int:
    """The ranks the production mesh needs: 256, or 512 with "pod"."""
    return 512 if multi_pod else 256


def world_rank() -> int:
    """This process's rank in the world, 0 without a process group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production mesh over a world of 256 ranks, 16 x 16
    ("data", "model"), or of 512, 2 x 16 x 16 with "pod" in front
    (``production_world``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = ((2, 16, 16), ("pod",) + AXES) if multi_pod else ((16, 16), AXES)
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=names)
