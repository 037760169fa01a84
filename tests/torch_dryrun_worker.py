"""The dry-run's fake worlds on the CPU, one process a world, for
``tests/test_torch_dryrun.py`` (the fake world is a default process group,
so no test process may hold one).

    python tests/torch_dryrun_worker.py --out out.json --check gloo|fake1|fake1deep|fake2x2 [--rank R]

* ``gloo``: a gloo world of one rank (a ``file://`` rendezvous beside
  ``--out``) runs tiny-650k's decode and prefill cells on a 1x1 mesh on
  real tensors of the cells' shapes (zeros), costed by ``utils/cost.measure``;
  then the dry-run's world is asked for and must be refused, naming gloo.
* ``fake1``: the same cells and tiny-650k's train cell on a fake 1x1 world
  through ``launch/dryrun.cost_cell`` (carried from one and two layers to
  three, the train cell from one and two of its four microbatches too),
  each also costed whole (three layers, four microbatches), and one record
  of ``run_cell``.
* ``fake1deep``: a five-layer tiny-650k's train cell on a fake 1x1 world,
  carried from one, two and three layers and costed whole.
* ``fake2x2``: the cells and tiny-650k's train cell on a fake 2x2 world as
  rank ``--rank``, with their divisors' inputs (placements, decode plan).

Every cell takes ``replicate_params_below=0`` (tiny models replicate by
default, and nothing would split).  Writes a JSON object of ProgramCost
fields a cell to ``--out``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.utils import cost  # noqa: E402

ARCH = "tiny-650k"
SHAPES = {"decode": ShapeConfig("decode_t", 64, 4, "decode"),
          "prefill": ShapeConfig("prefill_t", 32, 4, "prefill"),
          "train": ShapeConfig("train_t", 16, 4, "train")}
SPLIT = dict(replicate_params_below=0)
DEEP_LAYERS, DEEP_SHAPE = 5, ShapeConfig("train_deep", 16, 2, "train")


def real(tree):
    """A tree of fake tensors as real zeros of the same shapes and dtypes
    (dicts, lists, tuples, NamedTuples and dataclasses kept)."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: real(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(real(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(real(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: real(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def fields(pc) -> dict:
    return {k: v for k, v in dataclasses.asdict(pc).items() if k not in ("name", "cost_s")}


def gloo(out: Path) -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_mesh

    init_world("cpu", rank=0, world=1, init_file=str(out.with_suffix(".rdv")))
    mesh = make_mesh(1, 1, "cpu")
    got = {}
    for kind in ("decode", "prefill"):
        cell = specs.build_cell(ARCH, SHAPES[kind], mesh, sharder_kw=SPLIT)
        got[kind] = fields(cost.measure(kind, cell["fn"], *real(cell["args"])))
    try:
        dryrun.fake_mesh(mesh_shape=(1, 1))
        got["refused"] = ""
    except RuntimeError as e:
        got["refused"] = str(e)
    dist.destroy_process_group()
    return got


def fake(mesh_shape, rank: int) -> dict:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=mesh_shape[0] * mesh_shape[1])
    mesh = dryrun.fake_mesh(mesh_shape=mesh_shape)
    got = {}
    for kind in SHAPES:
        pc, meta, _, _, _ = dryrun.cost_cell(ARCH, SHAPES[kind], mesh, sharder_kw=SPLIT)
        got[kind] = fields(pc)
        got[kind + "_meta"] = meta
        if mesh_shape == (1, 1):
            whole = specs.build_cell(ARCH, SHAPES[kind], mesh, sharder_kw=SPLIT)
            got[kind + "_whole"] = fields(dryrun.measure_cell(whole))
    if mesh_shape == (1, 1):
        got["record"] = dryrun.run_cell(ARCH, SHAPES["decode"], mesh_shape=(1, 1), save=False,
                                        sharder_kw=SPLIT)
    else:
        cell = specs.build_cell(ARCH, SHAPES["decode"], mesh, sharder_kw=SPLIT)
        s = cell["sharder"]
        got["plan"] = {"decode_plan": list(s.decode_plan(SHAPES["decode"].global_batch)),
                       "tp_size": s.tp_size, "dp_size": s.dp_size,
                       "replicate": s.replicate, "head_pad": s.head_pad(),
                       "coord": list(s.coord(("data", "model")))}
    dist.destroy_process_group()
    return got


def deep() -> dict:
    """A five-layer tiny-650k's train cell (two microbatches, so only the
    depth is carried) on a fake 1x1 world, carried from one, two and three
    layers and costed whole."""
    mesh = dryrun.fake_mesh(mesh_shape=(1, 1))
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=DEEP_LAYERS)
    pc, meta, _, _, _ = dryrun.cost_cell(ARCH, DEEP_SHAPE, mesh, cfg=cfg, sharder_kw=SPLIT)
    whole = specs.build_cell(ARCH, DEEP_SHAPE, mesh, cfg=cfg, sharder_kw=SPLIT)
    return {"train_deep": fields(pc), "train_deep_meta": meta,
            "train_deep_whole": fields(dryrun.measure_cell(whole))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--check", required=True, choices=["gloo", "fake1", "fake1deep", "fake2x2"])
    ap.add_argument("--rank", type=int, default=0)
    a = ap.parse_args()
    torch.set_num_threads(1)   # the worlds run beside each other and the tests
    out = Path(a.out)
    if a.check == "gloo":
        got = gloo(out)
    elif a.check == "fake1deep":
        got = deep()
    else:
        got = fake((1, 1) if a.check == "fake1" else (2, 2), a.rank)
    out.write_text(json.dumps(got, default=str))
    os._exit(0)


if __name__ == "__main__":
    main()
