"""The dry-run (``launch/specs.py``, ``launch/dryrun.py``) and the cost
counter it runs on fake tensors (``utils/cost.py``), on the CPU.

The fake world is a default process group, so every check that starts a
world runs in a subprocess (``tests/torch_dryrun_worker.py``: a gloo world
of one rank, two fake 1x1 worlds, ranks 0 and 3 of a fake 2x2 world,
spawned at once); tiny-650k (3 layers) at small shapes, its weights split
(``replicate_params_below=0``).  The bars:

* one program costs the same on real tensors and under FakeTensorMode,
  without a mesh, for tiny-650k's decode, prefill and train cells: every
  count and the memory account equal (metadata queries such as
  ``prim.device``, which a fake tensor dispatches, cost nothing); the
  memory account tallies storages, and a unit only its outputs;
* a fake 1x1 world's decode and prefill, costed at one and two layers and
  carried to three (``dryrun.cost_cell``), equal a gloo world of one
  running the same cells on real tensors at full depth: FLOPs, dot FLOPs,
  HBM and collective bytes and the argument, output and alias bytes; the
  temp peak, an estimate, equal for decode and within 10% above for
  prefill; the dry-run's world is refused in the gloo process, naming
  gloo;
* the carried cost of each cell, the train cell's four microbatches from
  one and two too, and a five-layer train cell carried from one, two and
  three layers, against the same cell costed whole;
* ranks 0 and 3 of a fake 2x2 world cost the same, and each a quarter of
  the 1x1 world's dot FLOPs (the divisor is derived beside the assert);
* a ``reduced()`` MoE prefill (moonshot-v1's, experts 64 wide) runs under
  fake tensors and multiplies every expert, as the reference's prefill
  does;
* a record has the reference's keys, less ``xla_cost``;
* the dry-run's CLI exits 1 on a failing cell.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dryrun_worker as worker
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.models import lm, moe
from repro_torch.models.quantize import quantize_params
from repro_torch.utils import cost

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_dryrun_worker.py")
COUNTS = ("flops", "dot_flops", "hbm_bytes", "collective_bytes", "kernel_flops",
          "kernel_bytes", "argument_bytes", "output_bytes", "alias_bytes")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's numbers, the worker processes spawned at once."""
    d = tmp_path_factory.mktemp("dryrun")
    runs = {"gloo": ["--check", "gloo"], "fake1": ["--check", "fake1"],
            "deep": ["--check", "fake1deep"],
            "r0": ["--check", "fake2x2", "--rank", "0"],
            "r3": ["--check", "fake2x2", "--rank", "3"]}
    procs = {k: subprocess.Popen([sys.executable, str(WORKER), "--out", str(d / f"{k}.json"),
                                  *a], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
             for k, a in runs.items()}
    got = {}
    for k, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"{k}: {err[-3000:]}"
        got[k] = json.loads((d / f"{k}.json").read_text())
    return got


#: the cells without a mesh: the worker's, a train batch of 2 (2 microbatches)
SOLO = {**worker.SHAPES, "train": ShapeConfig("train_solo", 16, 2, "train")}


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_costs_equal_on_real_and_fake_tensors(kind):
    cell = specs.build_cell(worker.ARCH, SOLO[kind], None)
    args = cost._tree_tensors(cell["args"], [])
    # fake tensors on the CPU: the dry-run takes no device
    assert args and all(cost.is_fake(t) and t.device.type == "cpu" for t in args)
    fake = worker.fields(dryrun.measure_cell(cell))
    real = worker.fields(cost.measure(kind, cell["fn"], *worker.real(cell["args"]),
                                      grad=cell["grad"]))
    assert fake["dot_flops"] > 0 and fake["argument_bytes"] > 0
    assert fake == real


def test_memory_account_tallies_storages_and_a_units_outputs():
    a = torch.zeros(1000)   # 4,000 bytes

    def two_temps(a):
        t = a * 2
        u = t + 1   # the peak: t and u, 8,000 bytes beyond the argument
        del t
        return u

    pc = cost.measure("temps", two_temps, a)
    assert (pc.argument_bytes, pc.output_bytes, pc.alias_bytes) == (4000, 4000, 0)
    assert pc.temp_bytes == 8000 - 4000   # the peak less the new output
    pc = cost.measure("in_place", lambda a: a.add_(1), a)
    assert (pc.output_bytes, pc.alias_bytes, pc.temp_bytes) == (4000, 4000, 0)

    @cost.unit(lambda x: dict(flops=10))
    def kernel(x):
        scratch = torch.zeros(100_000)   # the plain version's, not the kernel's
        return x[:10] + scratch[:10]

    pc = cost.measure("unit", kernel, a)
    assert (pc.flops, pc.output_bytes, pc.temp_bytes) == (10, 40, 0)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_fake_1x1_world_equals_a_gloo_world_of_one(worlds, kind):
    real, fake = worlds["gloo"][kind], worlds["fake1"][kind]
    assert real["collective_bytes"] > 0 and real["dot_flops"] > 0
    assert {k: fake[k] for k in COUNTS} == {k: real[k] for k in COUNTS}
    # the temp peak, carried from a cut depth, is an estimate
    # (dryrun.cost_cell): a decode step's peak is one layer's, so the carry
    # is exact; a prefill's stops growing after the first layer, so the
    # affine carry overstates it: at least the whole run's, at most 10% more
    if kind == "decode":
        assert fake["temp_bytes"] == real["temp_bytes"] > 0
    else:
        assert real["temp_bytes"] <= fake["temp_bytes"] <= 1.1 * real["temp_bytes"]
    assert "'gloo'" in worlds["gloo"]["refused"]


@pytest.mark.parametrize("kind", ["decode", "prefill", "train", "train_deep"])
def test_carried_cost_equals_the_whole_cell(worlds, kind):
    # tiny-650k's three layers carried from one and two (serving cells), the
    # train cell's four microbatches from one and two, and a five-layer
    # tiny-650k's train cell (two microbatches, run whole) from one, two and
    # three layers (its backward's
    # stacked-weight gradient sums are quadratic in the depth), against the
    # cell costed whole on the same fake 1x1 world: every count equal; the
    # temp peak equal where each layer adds the same live bytes (train:
    # saved activations; the microbatches' peak, the second's) or none
    # (decode), and overstated by at most 10% where the peak stops growing
    # (prefill)
    world = worlds["deep" if kind == "train_deep" else "fake1"]
    carried, whole = world[kind], world[kind + "_whole"]
    assert {k: carried[k] for k in COUNTS} == {k: whole[k] for k in COUNTS}
    assert world[kind + "_meta"].get("microbatches", 1) == \
        {"train": 4, "train_deep": 2}.get(kind, 1)
    if kind == "prefill":
        assert whole["temp_bytes"] <= carried["temp_bytes"] <= 1.1 * whole["temp_bytes"]
    else:
        assert carried["temp_bytes"] == whole["temp_bytes"] > 0


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_fake_2x2_ranks_agree_and_split_the_work(worlds, kind):
    r0, r3, one = worlds["r0"], worlds["r3"], worlds["fake1"]
    # the slices are even (every dim tiny-650k splits divides 2), so the
    # two ranks at opposite corners count the same
    assert {k: r0[kind][k] for k in COUNTS} == {k: r3[kind][k] for k in COUNTS}
    assert r0["plan"]["coord"] == [0, 4] and r3["plan"]["coord"] == [3, 4]
    # the divisor from the placements (param_spec_tree) and the decode plan:
    # * B1's products and the tied head (tp_column_parallel): this rank's
    #   rows of x over the data axes (_row_part: 4 rows over dp = 2) times
    #   its rows of W over "model" (tp = 2) -> 1 / (dp * tp);
    # * decode attention: decode_plan(4) = (("data",), ("model",)): the
    #   batch over data, the cache's sequence over model -> 1 / (dp * tp);
    # * prefill attention: the batch over data (constrain) and head_pad() = 4
    #   q heads over model -> 1 / (dp * tp);
    # * train: the batch split over data for the whole step (half the
    #   microbatches of the 1x1 world's rule, one row each), the weights
    #   gathered over data and split over model -> 1 / (dp * tp).
    plan = r0["plan"]
    assert plan["decode_plan"] == [["data"], ["model"]] and plan["head_pad"] == 4
    divisor = plan["dp_size"] * plan["tp_size"]
    assert divisor == 4 and not plan["replicate"]
    assert r0[kind]["dot_flops"] * divisor == one[kind]["dot_flops"]
    assert r0[kind]["collective_bytes"] > 0


def test_moe_prefill_multiplies_every_expert_on_fake_tensors(monkeypatch):
    # an expert width of whole 64-blocks, so the 4-bit experts take the
    # kernels' route (row-structured storage), the one that picks experts
    cfg = get_arch("moonshot-v1-16b-a3b").reduced(moe_d_ff=64)
    shape = ShapeConfig("prefill_moe", 16, 2, "prefill")
    seen = []
    per_expert = moe._experts_per_expert

    def spy(params, work, active, cfg):
        seen.append(list(active))
        return per_expert(params, work, active, cfg)

    monkeypatch.setattr(moe, "_experts_per_expert", spy)
    cell = specs.build_cell("moe", shape, None, cfg=cfg)
    fake = dryrun.measure_cell(cell)
    assert seen == [list(range(cfg.n_experts))] * cfg.n_layers
    seen.clear()
    params = quantize_params(lm.init_params(cfg, device="cpu"), specs.SERVE_QUANT, cfg,
                             device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)),
                             dtype=torch.int32)
    real = cost.measure("prefill", cell["fn"], params, tokens)
    # 32 random tokens routed top-2 over 4 experts reach every expert, so the
    # real prefill multiplies them all too
    assert seen == [list(range(cfg.n_experts))] * cfg.n_layers
    assert fake.dot_flops == real.dot_flops > 0


def _reference_record_keys() -> dict:
    """The keys of the reference's ok record, from its source: the dict it
    starts from, ``record.update``'s keywords (and the dicts they hold) and
    ``_roofline``'s."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys: dict = {"": set()}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                any(isinstance(t, ast.Name) and t.id == "record" for t in node.targets):
            keys[""] |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr == "update" and isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "record" and node.keywords:
            for kw in node.keywords:
                keys[""].add(kw.arg)
                if isinstance(kw.value, ast.Call):
                    keys[kw.arg] = {k.arg for k in kw.value.keywords}
        if isinstance(node, ast.FunctionDef) and node.name == "_roofline":
            ret = next(n for n in ast.walk(node) if isinstance(n, ast.Return))
            keys[""].add(ret.value.keys[0].value)
            keys[ret.value.keys[0].value] = {k.value for k in ret.value.values[0].keys}
    return keys


def test_record_has_the_references_keys_less_xla_cost(worlds):
    want = _reference_record_keys()
    assert "xla_cost" in want[""]
    want[""].discard("xla_cost")
    del want["xla_cost"]
    rec = worlds["fake1"]["record"]
    assert set(rec) == want[""]
    for k in ("memory", "hlo_cost", "roofline"):
        assert set(rec[k]) == want[k], k
    assert rec["status"] == "ok" and rec["mesh"] == "1x1" and rec["devices"] == 1
    m = rec["memory"]
    assert m["peak_estimate"] == m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"] \
        - m["alias_bytes"]
    assert m["alias_bytes"] > 0   # the caches, written in place


def test_cli_exits_1_on_a_failing_cell(tmp_path):
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "no-such-arch", "--shape", "decode_32k"], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert p.returncode == 1, p.stderr[-2000:]
    assert "[FAIL] no-such-arch x decode_32k x pod16x16" in p.stdout
    assert "1 FAILURES" in p.stdout


def test_the_world_needs_fake_pg_and_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, dryrun.FAKE_PG, None)   # as if torch lacked it
    with pytest.raises(RuntimeError, match=dryrun.FAKE_PG.replace(".", r"\.")):
        dryrun.fake_mesh(mesh_shape=(1, 1))
