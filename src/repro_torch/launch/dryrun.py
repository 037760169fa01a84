"""The dry-run: every (architecture x input shape x mesh) cell built on the
production mesh and costed, without a device — port of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--skip-existing]

The reference lowers and compiles each cell on 512 placeholder XLA devices.
Here the placeholder world is a fake process group
(``torch.testing._internal.distributed.fake_pg``: 256 ranks, or 512 with
"pod", every collective returning at once with nothing moved) and the
tensors are fake (``launch/specs.py``: shapes and dtypes, no data), so the
dry-run runs on any machine and needs no card; it takes no device, builds
no CUDA tensor and launches no kernel.  The world is started inside
``run_cell``/``main`` (once a mesh; cells run one after another in this
process), never at import; it is refused where the process already holds a
default group of another backend.  The process is rank 0 of the world and
its record is rank 0's.

Per cell this records into ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(the reference's keys, where the port has the quantity):

* ``memory``: argument, output, temp and alias bytes of this rank's call and
  the reference's ``peak_estimate`` (``utils/cost.py``'s storage tally:
  bytes as tensors hold them, no allocator; the temp peak, and so
  ``peak_estimate``, an estimate where the cell is carried from a cut
  depth: ``cost_cell``);
* ``hlo_cost``: FLOPs, HBM bytes and collective bytes a rank
  (``utils/cost.measure``: every aten op counted, the kernels' units charged
  from shapes, each collective its per-rank payload);
* the roofline terms at the H100's rates (``_roofline``: ``PEAK_FLOPS_BF16``,
  ``HBM_BW``, ``NET_BW`` of ``device.py``);
* ``lower_s``: the seconds to build the cell, ``compile_s``: to run and
  cost it.

These are counts of the program the port would run, not measurements of a
card.  The reference's ``xla_cost`` (XLA's own cost analysis) has no
counterpart, as there is no compiler here, and neither has ``--hlo-dir``
(there is no HLO text to dump).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.launch.specs import Skip
from repro_torch.utils import cost

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "x".join(str(n) for n in mesh_shape)
    return "pod2x16x16" if multi_pod else "pod16x16"


def fake_mesh(*, multi_pod: bool = False, mesh_shape=None):
    """The production mesh (``launch/mesh.make_production_mesh``) on a fake
    world of its size, this process rank 0; ``mesh_shape`` (data, model),
    for the tests, a smaller one.  A fake world of another size is replaced;
    a default group of another backend is refused."""
    import importlib

    import torch.distributed as dist

    try:
        importlib.import_module(FAKE_PG)   # registers the "fake" backend
    except ImportError as e:
        raise RuntimeError(f"the dry-run's world needs {FAKE_PG}, which this torch "
                           f"lacks: {e}") from e
    size = math.prod(mesh_shape) if mesh_shape is not None \
        else mesh_mod.production_world(multi_pod=multi_pod)
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(f"the dry-run runs on a fake process group, and this process "
                               f"already has a default group of backend {backend!r}")
        if dist.get_world_size() != size:
            dist.destroy_process_group()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    if mesh_shape is not None:
        return mesh_mod.make_mesh(*mesh_shape, device="cpu")
    return mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")


def measure_cell(cell) -> cost.ProgramCost:
    """One cell's step run once under its fake mode and costed."""
    with cell["mode"]:
        return cost.measure(cell["meta"]["kind"], cell["fn"], *cell["args"],
                            grad=cell["grad"])


def _carry(values: list, n: int) -> float:
    """The polynomial through ``values`` at 1, 2, ... carried to ``n``: the
    line through two points, the parabola through three."""
    v1, v2 = values[0], values[1]
    out = v1 + (n - 1) * (v2 - v1)
    if len(values) == 3:
        out += (n - 1) * (n - 2) // 2 * (values[2] - 2 * v2 + v1)
    return out


def cost_cell(arch: str, shape, mesh, **cell_kw):
    """(the cell's cost, the whole cell's meta and cfg, seconds building,
    seconds costing): its step costed at a few scan periods of the stack
    (and a train cell at one and two of its microbatches), carried to the
    whole depth and microbatch count.  Every period runs the same ops on the
    same shapes, and so does every microbatch, so a serving cell's counts
    (FLOPs, bytes moved, the argument, output and alias bytes) are affine in
    the depth: costed at one and two periods, the line through them is the
    whole program's count exactly (the reference's cost multiplies a scan
    body by its trip count alike).  A train cell's backward also sums each
    layer's gradient of a stacked weight into a gradient of the whole stack
    (autograd's select backward), a term quadratic in the depth, so it is
    costed at one, two and three periods and carried along the parabola
    through them, and carried affinely over its microbatches: exact too.

    The temp bytes are a peak, not a sum, and only estimated: carried along
    the same line or parabola in depth, which is exact where each period
    adds the same live bytes (a train step's saved activations; a decode
    step's peak, one layer's) and overstates a peak that stops growing
    after the first period (a prefill's); over microbatches the peak of
    two, which every later microbatch repeats (the accumulated gradients
    live from the first on).  A stack of as few periods as the carry costs,
    or one ``specs.cut_depth`` cannot cut, runs whole.  ``cell_kw``:
    ``build_cell``'s test-only options.  Raises ``Skip``."""
    cfg = cell_kw.get("cfg") or get_arch(arch)
    run = SHAPES[shape] if isinstance(shape, str) else shape
    try:
        specs.cut_depth(cfg, 1)
        K = cfg.n_layers // cfg.scan_period()
    except ValueError:
        K = 0
    dp = math.prod(n for n, a in zip(mesh.shape, mesh.mesh_dim_names) if a != "model")
    train = run.kind == "train"
    M = specs.microbatches(run, dp) if train else 1
    ks = (1, 2, 3) if train else (1, 2)
    ks = ks if K > len(ks) else (None,)
    ms = (1, 2) if M > 2 else (None,)
    kw = {"quant": specs.SERVE_QUANT, "cfg": None, "sharder_kw": None, **cell_kw}
    built = costed = 0.0
    got = {}
    for k in ks:
        for m in ms:
            t0 = time.time()
            cell = specs._build_cell(arch, shape, mesh, periods=k, micro=m, **kw)
            t1 = time.time()
            got[k, m] = measure_cell(cell)
            built, costed = built + t1 - t0, costed + time.time() - t1
            meta = cell["meta"]
            del cell
    fields = [f.name for f in dataclasses.fields(cost.ProgramCost)
              if f.name not in ("name", "cost_s")]

    def at(name, m):
        if ks == (None,):
            return getattr(got[None, m], name)
        return _carry([getattr(got[k, m], name) for k in ks], K)

    out = {f: at(f, ms[-1]) if f == "temp_bytes" or ms == (None,)
           else _carry([at(f, 1), at(f, 2)], M) for f in fields}
    out["temp_bytes"] = max(out["temp_bytes"], 0.0)
    pc = cost.ProgramCost(name=meta["kind"], cost_s=costed, **out)
    return pc, meta, cfg, built, costed


def run_cell(arch: str, shape: str, *, multi_pod: bool = False, save: bool = True,
             mesh_shape=None, **cell_kw) -> dict:
    """Build and cost one cell on the fake world; its record (saved unless
    ``save`` is False).  ``mesh_shape`` and ``cell_kw`` (``build_cell``'s
    test-only options) serve the tests."""
    name = mesh_name(multi_pod, mesh_shape)
    mesh = fake_mesh(multi_pod=multi_pod, mesh_shape=mesh_shape)
    shape_name = shape if isinstance(shape, str) else shape.name
    record = {"arch": arch, "shape": shape_name, "mesh": name, "devices": mesh.size()}
    try:
        pc, meta, cfg, t_lower, t_compile = cost_cell(arch, shape, mesh, **cell_kw)
    except Skip as e:
        record["status"] = "skipped"
        record["reason"] = str(e)
        print(f"[skip] {arch} x {shape_name} x {name}: {e}")
        if save:
            _save(record)
        return record

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = meta["tokens"]
    kind = meta["kind"]
    mult = 6 if kind == "train" else 2
    model_flops = mult * n_active * tokens  # global

    record.update(
        status="ok",
        kind=kind,
        lower_s=round(t_lower, 1),
        compile_s=round(t_compile, 1),
        tokens=tokens,
        n_params=n_params,
        n_active_params=n_active,
        model_flops_global=model_flops,
        memory=dict(
            argument_bytes=pc.argument_bytes,
            output_bytes=pc.output_bytes,
            temp_bytes=pc.temp_bytes,
            alias_bytes=pc.alias_bytes,
            peak_estimate=pc.argument_bytes + pc.temp_bytes + pc.output_bytes
            - pc.alias_bytes,
        ),
        hlo_cost=dict(
            flops_per_device=pc.flops,
            hbm_bytes_per_device=pc.hbm_bytes,
            collective_bytes_per_device=pc.collective_bytes,
        ),
    )
    record.update(_roofline(record, mesh.size()))
    hbm_gb = record["memory"]["peak_estimate"] / 1e9
    print(
        f"[ok] {arch} x {shape_name} x {name}: "
        f"cost {t_compile:.0f}s, peak {hbm_gb:.2f} GB/dev, "
        f"terms(ms) C={record['roofline']['compute_ms']:.2f} "
        f"M={record['roofline']['memory_ms']:.2f} "
        f"N={record['roofline']['collective_ms']:.2f} "
        f"-> {record['roofline']['bottleneck']}"
    )
    if save:
        _save(record)
    return record


def _roofline(record: dict, n_chips: int) -> dict:
    c = record["hlo_cost"]
    compute_s = c["flops_per_device"] / mesh_mod.PEAK_FLOPS_BF16
    memory_s = c["hbm_bytes_per_device"] / mesh_mod.HBM_BW
    collective_s = c["collective_bytes_per_device"] / mesh_mod.NET_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = record["model_flops_global"] / max(
        c["flops_per_device"] * n_chips, 1.0
    )
    step_s = max(terms.values())
    mfu = record["model_flops_global"] / (
        n_chips * mesh_mod.PEAK_FLOPS_BF16 * step_s
    ) if step_s > 0 else 0.0
    return {
        "roofline": {
            "compute_ms": compute_s * 1e3,
            "memory_ms": memory_s * 1e3,
            "collective_ms": collective_s * 1e3,
            "bottleneck": bottleneck,
            "useful_flops_ratio": useful,
            "roofline_mfu": mfu,
        }
    }


def _save(record: dict):
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(ARTIFACTS / name, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                name = mesh_name(multi_pod)
                out = ARTIFACTS / f"{arch}__{shape}__{name}.json"
                if args.skip_existing and out.exists():
                    print(f"[cached] {arch} x {shape} x {name}")
                    continue
                try:
                    run_cell(arch, shape, multi_pod=multi_pod)
                except Exception:
                    failures.append((arch, shape, name))
                    print(f"[FAIL] {arch} x {shape} x {name}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nDry-run complete: all cells built and costed.")


if __name__ == "__main__":
    main()
