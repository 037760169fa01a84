"""The roofline (``paper/roofline.py``), the dry-run's tables
(``paper/make_experiments.py``) and the cells' plan (``launch/specs.py``)
held to the reference's, on the CPU, without a process group:

* ``_quantized_weight_bytes``, ``_kv_cache_bytes`` and
  ``analytic_memory_floor`` equal ``benchmarks/roofline.py``'s for every
  assigned arch, every shape, every kind and both meshes (rel 1e-12: the
  same arithmetic in the same order, so in fact equal);
* ``launch/dryrun._roofline`` equals the reference's ``_roofline`` on the
  same records, the reference's rates set to the H100's for the test
  (its function is taken from its source, as importing
  ``repro/launch/dryrun.py`` would set a 512-device XLA flag);
* ``make_experiments``' three sections, ``roofline.markdown_table`` and the
  roofline suite's rows (also through ``paper/run.py --only roofline``)
  print the reference's text on the same records in a ``tmp_path``, save
  the headings' wording (H100s, not TPU pods);
* the skipped cells and their reasons are the reference's ``Skip``s, both
  raised before the mesh is touched;
* the train cells' microbatch count and batch shapes equal the reference's
  on 16x16 and 2x16x16 (its ``build_cell`` on an abstract mesh), and the
  decode cells' whole caches its shapes and dtypes;
* quantized shells built from shapes equal a real ``quantize_params`` of
  each ``reduced()`` arch leaf for leaf, in shape and dtype.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.launch import dryrun, specs
from repro_torch.models import lm, seq2seq
from repro_torch.models.quantize import quantize_params
from repro_torch.models.sharding import Sharder
from repro_torch.paper import make_experiments as mx
from repro_torch.paper import roofline as rl

ROOT = Path(__file__).resolve().parents[1]
#: the H100 SXM's rates (device.py) in place of the reference's TPU v5e ones
H100 = dict(PEAK_FLOPS_BF16=989e12, HBM_BW=3.35e12, ICI_BW=50e9)
REL = 1e-12
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


_COUNTED: dict = {}


@pytest.fixture(autouse=True)
def _counted_once(monkeypatch):
    """The reference's parameter counts (a traced init each, about a second
    at full size) counted once a config for the file's tests."""
    from repro.configs.base import ArchConfig

    for name in ("param_count", "active_param_count"):
        if name not in _COUNTED:
            _COUNTED[name] = functools.cache(getattr(ArchConfig, name))
        monkeypatch.setattr(ArchConfig, name, _COUNTED[name])


def _ref():
    from benchmarks import make_experiments as ref_mx
    from benchmarks import roofline as ref_rl
    from repro.configs.registry import ASSIGNED as REF_ASSIGNED
    from repro.configs.registry import get_arch as ref_arch
    return SimpleNamespace(mx=ref_mx, rl=ref_rl, assigned=REF_ASSIGNED, arch=ref_arch)


def test_assigned_is_the_references():
    assert sorted(ASSIGNED) == sorted(_ref().assigned) and len(ASSIGNED) == 10


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_analytic_floor_matches_reference(arch):
    ref = _ref()
    cfg, rcfg = get_arch(arch), ref.arch(arch)
    assert rl._quantized_weight_bytes(cfg) == pytest.approx(
        ref.rl._quantized_weight_bytes(rcfg), rel=REL)
    for shape in SHAPES.values():
        assert rl._kv_cache_bytes(cfg, shape) == pytest.approx(
            ref.rl._kv_cache_bytes(rcfg, shape), rel=REL)
        for kind in ("train", "prefill", "decode"):
            for chips in (256, 512):
                for micro in (8, 16):
                    assert rl.analytic_memory_floor(cfg, shape, kind, chips, micro) == \
                        pytest.approx(ref.rl.analytic_memory_floor(rcfg, shape, kind, chips,
                                                                   micro), rel=REL)


def _reference_roofline(monkeypatch):
    """The reference's ``_roofline`` from its source, over its own
    ``repro.launch.mesh`` with the H100's rates."""
    import repro.launch.mesh as ref_mesh

    for k, v in H100.items():
        monkeypatch.setattr(ref_mesh, k, v)
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_roofline")
    ns = {"mesh_mod": ref_mesh}
    exec(compile(ast.Module([fn], []), "repro/launch/dryrun.py", "exec"), ns)
    return ns["_roofline"]


def _records(seed: int) -> list:
    """Records of every assigned arch and shape on both meshes, with
    seeded numbers: ok cells and the documented skips."""
    rng = np.random.default_rng(seed)
    out = []
    for mesh, devices in (("pod16x16", 256), ("pod2x16x16", 512)):
        for arch in sorted(ASSIGNED):
            for shape in SHAPES.values():
                r = {"arch": arch, "shape": shape.name, "mesh": mesh, "devices": devices}
                ok, why = specs.shape_applicable(get_arch(arch), shape)
                if not ok:
                    out.append(dict(r, status="skipped", reason=why))
                    continue
                c = dict(flops_per_device=float(rng.uniform(1e9, 1e15)),
                         hbm_bytes_per_device=float(rng.uniform(1e8, 1e12)),
                         collective_bytes_per_device=float(rng.uniform(0, 1e11)))
                mem = {k: float(rng.uniform(1e6, 1e11)) for k in
                       ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                        "peak_estimate")}
                r.update(status="ok", kind=shape.kind, lower_s=float(rng.uniform(0, 100)),
                         compile_s=float(rng.uniform(0, 1000)), tokens=shape.global_batch,
                         model_flops_global=float(rng.uniform(1e12, 1e18)), memory=mem,
                         hlo_cost=c)
                out.append(r)
    return out


def test_roofline_terms_match_reference(monkeypatch):
    ref_roofline = _reference_roofline(monkeypatch)
    for r in _records(0):
        if r["status"] == "ok":
            assert dryrun._roofline(r, r["devices"]) == ref_roofline(r, r["devices"])


def _not_heading(text: str) -> list:
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


def test_tables_print_the_references_text(tmp_path, monkeypatch, capsys):
    ref = _ref()
    ref_roofline = _reference_roofline(monkeypatch)
    for d, records in (("dryrun", _records(1)), ("dryrun_baseline", _records(2))):
        for r in records:
            if r["status"] == "ok":
                r.update(ref_roofline(r, r["devices"]))
            for where in (d, d.replace("dryrun", "dryrun_torch")):
                (tmp_path / where).mkdir(exist_ok=True)
                (tmp_path / where / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(
                    json.dumps(r))
    monkeypatch.setattr(ref.mx, "ROOT", tmp_path)
    monkeypatch.setattr(mx, "ROOT", tmp_path)
    monkeypatch.setattr(ref.rl, "ART", tmp_path / "dryrun")
    monkeypatch.setattr(rl, "ART", tmp_path / "dryrun_torch")
    monkeypatch.setattr(ref.mx, "HBM_BW", H100["HBM_BW"])
    monkeypatch.setattr(ref.rl, "HBM_BW", H100["HBM_BW"])
    for section in ("dryrun_section", "roofline_section", "perf_deltas"):
        getattr(ref.mx, section)()
        want = capsys.readouterr().out
        getattr(mx, section)()
        got = capsys.readouterr().out
        assert len(want.splitlines()) > 8
        assert _not_heading(got) == _not_heading(want), section
    for mesh in ("pod16x16", "pod2x16x16"):
        assert rl.markdown_table(mesh) == ref.rl.markdown_table(mesh)
    logged, ref_logged = [], []
    assert rl.run(log=logged.append) == ref.rl.run(log=ref_logged.append)
    assert logged == ref_logged and len(logged) > 40
    # the roofline suite through the port's suite runner, as the reference's
    # runner calls it
    from repro_torch.paper import run as paper_run

    paper_run.main(["--only", "roofline"])
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert rows[1:] == [f"{r[0]},{r[1]:.1f},{r[2]}" for r in ref.rl.run(log=lambda *a: None)[0]]


class _Touched(Exception):
    pass


class _Untouched:
    """A mesh that must not be read: any attribute raises."""

    def __getattr__(self, name):
        raise _Touched(name)


def _skip_of(build, skip, arch, shape):
    try:
        build(arch, shape, _Untouched())
    except skip as e:
        return str(e)
    except _Touched:
        return None
    raise AssertionError(f"{arch} x {shape} built without reading its mesh")


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_skips_match_reference(arch):
    from repro.launch import specs as ref_specs

    for shape in SHAPES:
        want = _skip_of(ref_specs.build_cell, ref_specs.Skip, arch, shape)
        assert _skip_of(specs.build_cell, specs.Skip, arch, shape) == want
    if arch in ("qwen2-7b", "seamless-m4t-large-v2"):
        assert _skip_of(specs.build_cell, specs.Skip, arch, "long_500k")


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


@pytest.mark.parametrize("mesh_shape", sorted(MESHES))
def test_train_plan_matches_reference(mesh_shape, monkeypatch):
    """Microbatches and batch shapes of every train cell, the reference's
    from its own ``build_cell``: its step maker records the count, and its
    state's init, which neither reads, is an empty tree."""
    from jax.sharding import AbstractMesh

    from repro.launch import specs as ref_specs

    seen = {}

    def record_step(cfg, *, sharder=None, microbatches=1, **kw):
        seen["micro"] = microbatches
        return lambda *a: None

    def no_state(key, cfg, param_dtype):
        return ref_specs.step_mod.TrainState(params={}, opt=None, err=None)

    monkeypatch.setattr(ref_specs.step_mod, "make_train_step", record_step)
    monkeypatch.setattr(ref_specs.step_mod, "init_state", no_state)
    names = MESHES[mesh_shape]
    stand_in = SimpleNamespace(mesh_dim_names=names, shape=mesh_shape)
    shape = SHAPES["train_4k"]
    for arch in sorted(ASSIGNED):
        cell = ref_specs.build_cell(arch, "train_4k", AbstractMesh(mesh_shape, names))
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in cell["args"][1].items()}
        cfg = get_arch(arch)
        dp = Sharder(stand_in, cfg).dp_size
        assert dp == cell["sharder"].dp_size
        assert specs.microbatches(shape, dp) == seen["micro"]
        got = {k: (s, _dtype(d)) for k, (s, d) in specs.batch_shapes(cfg, shape).items()}
        assert got == want, arch


def _leaf_sigs(tree) -> list:
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, path)
        elif t is not None:
            out.append((path[-1] if path else "", tuple(t.shape), _dtype(t.dtype)))

    walk(tree, ())
    return sorted(out)


def test_decode_caches_match_reference():
    """Every decode cell's whole caches: lm.init_caches(cfg, B, S) against
    the reference's (a tuple a period position of stacked leaves alike),
    and seamless's self and cross caches against its decode cell's."""
    import jax
    from jax.sharding import AbstractMesh
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs.registry import get_arch as ref_arch
    from repro.launch import specs as ref_specs
    from repro.models import lm as ref_lm

    for arch in sorted(ASSIGNED):
        cfg = get_arch(arch)
        for shape in SHAPES.values():
            if shape.kind != "decode" or not specs.shape_applicable(cfg, shape)[0]:
                continue
            B, S = shape.global_batch, shape.seq_len
            with FakeTensorMode():
                if cfg.encoder_decoder:
                    self_c, cross = specs.seq2seq_caches(cfg, B, S)
                    got = (_leaf_sigs(self_c), _leaf_sigs({"k": cross["k"], "v": cross["v"]}))
                    assert cross["pos"].shape == (cfg.n_layers, S)
                else:
                    got = _leaf_sigs(lm.init_caches(cfg, B, S, device="cpu"))
            if cfg.encoder_decoder:
                cell = ref_specs.build_cell(arch, shape.name,
                                            AbstractMesh((16, 16), ("data", "model")))
                ref_self, (kx, vx) = cell["args"][2]
                want = (_leaf_sigs(ref_self), _leaf_sigs({"k": kx, "v": vx}))
            else:
                want = _leaf_sigs(jax.eval_shape(
                    lambda: ref_lm.init_caches(ref_arch(arch), B, S)))
            assert got == want, (arch, shape.name)


def _sig(tree) -> list:
    """(path, shape, dtype) of every tensor and the non-tensor fields of
    every QuantizedTensor of a params tree."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif dataclasses.is_dataclass(t):
            fields = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
            out.append((path, "meta", sorted((k, v) for k, v in fields.items()
                                             if not isinstance(v, (torch.Tensor, type(None))))))
            for k, v in fields.items():
                if isinstance(v, torch.Tensor) or v is None:
                    walk(v, path + (k,))
        elif t is None:
            out.append((path, None))
        else:
            out.append((path, tuple(t.shape), t.dtype))

    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_quantized_shells_match_quantize_params(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_arch(arch).reduced()
    init = seq2seq.init_params if cfg.encoder_decoder else lm.init_params
    real = quantize_params(init(cfg, device="cpu"), specs.SERVE_QUANT, cfg, device="cpu")
    with FakeTensorMode():
        shells = specs.quantized_shells(cfg)
    want, got = _sig(real), _sig(shells)
    assert len(want) > 20 and got == want
