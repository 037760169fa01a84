"""Mixture-of-experts, SSM and hybrid decoders on a mesh of ranks
(``models/sharding.py``, ``models/moe.py``, ``models/ssm.py``), on the CPU:
the ``reduced()`` configs of moonshot-v1-16b-a3b (4 experts, top-2),
mamba2-130m (8 SSD heads) and jamba-v0.1-52b (its 8-layer period twice),
the reference's inits carried across with ``interop``, inputs from a numpy
seed.

Gloo worlds of 2 (1x2, 2x1) and 4 (1x4, 2x2) ("data", "model") meshes are
spawned once each, all at once (``tests/torch_moe_ssm_mesh_worker.py``, no
JAX), beside the reference's own sharded steps on 4 forced host devices
(``tests/torch_train_mesh_reference.py``: mamba2 at 2x2, moonshot at 1x4).
The bars:

* (a) placements: the param placements of dense and 4-bit trees and the
  cache placements (slots and shared positions, kv16 and kv4, the SSM
  state and conv) equal the reference's ``param_spec_tree`` and
  ``cache_spec_tree`` leaf for leaf at 1x2, 2x1 and 2x2; each rank stores
  the whole leaf's bytes over its shard count (the 4-bit tree as served,
  cut over "model"; the dense train state cut over both axes);
* (b) the MoE layer alone, the same whole input on every rank: in serving
  at 1x2 and 1x4 its output and aux equal the unsharded ``moe_ffn``'s bit
  for bit (dense experts, 4-bit fused and 4-bit dequant_einsum; 16 dispatch
  groups, one, one under a pad mask, a decode step with an idle row); in
  training at 2x1 and 2x2 with a capacity that drops tokens, the loss
  sum(y * r) + 1000 aux within 1e-3 and the gradients of x and of every
  leaf of the layer within 0.05 of that leaf's max |g| of the unsharded
  run's (mutations: a dispatch over each rank's own tokens puts the loss
  11.6-16.9 off in every case, and an all-gather of the tokens whose
  adjoint is a slice puts x's gradient 0.26 off in the one-group cases);
* (c) the SSM layer alone, sequence mode and 4 decode steps, heads split at
  1x2 and 1x4, within 0.08 (the dense bar of
  ``tests/test_torch_mesh_serving.py``), also where "model" does not divide
  the heads (6 heads at 1x4: kept whole) and with 2 groups of 4 heads;
* (d) whole models: served (bf16 cache, teacher-forced on the port's
  unsharded greedy tokens, the same tokens fed to the reference) at 2x2,
  on the rows whose routes agree with the unsharded run's (router flips:
  top-k choices and kept slots, counted and recorded; jamba flips 3
  choices of one row), within the reference's own 2x2 sharded rollout's
  gap to its unsharded one plus 0.08 of the port's unsharded logits (the
  sequence-sharded combine's roundings grow through jamba's 16 layers:
  0.15 here, the reference's own 2.4), and no further from the
  reference's unsharded logits than the port's unsharded ones plus that;
  the sharded one-slot Server's tokens at kv4 on 4-bit weights equal to
  the sharded batch-1 Engine's; one train step at 2x2 (and moonshot at
  1x4) within 1e-3 in loss and 0.05 of each leaf's max |g| of the port's
  unsharded step, and no further from the reference's unsharded step than
  the port's unsharded step plus those bars (jamba's is 0.40 off it before
  any mesh: ROADMAP C7); mamba2 also within 0.05 of the reference's own
  2x2 sharded step and moonshot of its 1x4 one.  The reference's sharded
  MoE step is no oracle where "data" > 1 (ROADMAP C7).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import sharding as rsh  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from test_torch_sharding import QT_FIELDS, RefMesh, _leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_moe_ssm_mesh_worker.py"
REFERENCE = ROOT / "tests" / "torch_train_mesh_reference.py"
SERVE_REFERENCE = ROOT / "tests" / "torch_mesh_serving_reference.py"
ARCHS = {"moonshot": "moonshot-v1-16b-a3b", "mamba2": "mamba2-130m",
         "jamba": "jamba-v0.1-52b"}
#: serving: prompts [B, SP], N tokens teacher-forced, a cache budget of S
B, SP, N, S = 4, 8, 8, 24
#: training: a batch of 4 x 32 (one dispatch group: the tokens gathered over "data")
TRAIN_B, TRAIN_S, LOSS_CHUNK = 4, 32, 32
LOSS_BAR, GRAD_BAR, BF16_BAR = 1e-3, 0.05, 0.08
NO_EXCESS = {"xla_allow_excess_precision": False}
#: the checks of each world, and the archs each world trains whole
WORLDS = {"1x2": ["moe_serve", "ssm"], "1x4": ["moe_serve", "ssm", "models_train"],
          "2x1": ["moe_train"], "2x2": ["moe_train", "models_serve", "models_train"]}
TRAIN_ARCHS = {"1x4": ["moonshot"], "2x2": list(ARCHS)}
#: the reference's own sharded steps that are an oracle (module docstring)
REF_SHARDED = {"mamba2": "2x2", "moonshot": "1x4"}


@functools.lru_cache(maxsize=None)
def _raw(short: str, quantized: bool = False):
    """The reference's init of a reduced() config (4-bit float b64 when
    ``quantized``), as jax arrays."""
    rcfg = r_get_arch(ARCHS[short]).reduced()
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    if quantized:
        raw = jax.jit(lambda p: r_quantize_params(
            p, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg))(raw)
    return raw


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    """The worlds' input: every arch's raw init as numpy, the layer inputs,
    the prompts and the training batch, all from numpy seeds."""
    rs = np.random.RandomState(0)
    t = rs.randint(0, 256, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    return {"raw": {k: jax.tree.map(np.asarray, _raw(k)) for k in ARCHS},
            "moe_x": rs.randn(256, 64).astype(np.float32),
            "moe_r": rs.randn(256, 64).astype(np.float32),
            "ssm_u": rs.randn(2, 16 + N, 64).astype(np.float32),
            "prompts": rs.randint(0, 256, (B, SP)).astype(np.int32),
            "tokens": t[:, :-1], "labels": t[:, 1:], "loss_chunk": LOSS_CHUNK,
            "n": N, "S": S}


def _ref_grads(short: str):
    """(loss, {keystr: gradient}) of the reference's unsharded jitted step."""
    rcfg = r_get_arch(ARCHS[short]).reduced()
    inp = _inputs()
    f = jax.jit(jax.value_and_grad(
        lambda p, t, y: rlm.loss_fn(p, t, y, rcfg, loss_chunk=LOSS_CHUNK)),
        compiler_options=NO_EXCESS)
    value, grads = f(_raw(short), inp["tokens"], inp["labels"])
    return float(value), {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                          for k, v in jax.tree_util.tree_leaves_with_path(grads)}


def _force() -> dict:
    """{short name: the port's unsharded greedy tokens [B, N]}, which every
    served rollout is fed (the worker's own rollout, in this process)."""
    import torch_moe_ssm_mesh_worker as worker

    inp = _inputs()
    out = {}
    for short in ARCHS:
        params = interop.params_from_reference(inp["raw"][short], device="cpu")
        out[short], _, _ = worker.rollout(worker.cfg_of(short), params,
                                          torch.as_tensor(inp["prompts"]), S, N)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's numbers and the reference's: all the gloo worlds and
    the reference's sharded steps started at once; the reference's
    unsharded steps and rollouts computed here meanwhile."""
    d = tmp_path_factory.mktemp("moe_ssm_mesh")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    force = _force()
    procs = {}
    for mesh, checks in WORLDS.items():
        inp, out = d / f"in{mesh}.pkl", d / f"out{mesh}.npz"
        with open(inp, "wb") as f:
            pickle.dump({**_inputs(), "checks": checks, "force": force,
                         "train_archs": TRAIN_ARCHS.get(mesh, [])}, f)
        procs[mesh] = (subprocess.Popen(
            [sys.executable, str(WORKER), "--mesh", mesh, "--inp", str(inp), "--out",
             str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
            out)
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
               "JAX_PLATFORMS": "cpu"}
    for short, mesh in REF_SHARDED.items():
        inp, out = d / f"ref_{short}.pkl", d / f"ref_{short}.npz"
        with open(inp, "wb") as f:
            pickle.dump({"raw": _inputs()["raw"][short], "tokens": _inputs()["tokens"],
                         "labels": _inputs()["labels"], "loss_chunk": LOSS_CHUNK}, f)
        procs[f"ref_{short}"] = (subprocess.Popen(
            [sys.executable, str(REFERENCE), "--mesh", mesh, "--arch", ARCHS[short],
             "--reduced", "--inp", str(inp), "--out", str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=ref_env), out)
    inp, out = d / "ref_serve.pkl", d / "ref_serve.npz"
    with open(inp, "wb") as f:
        pickle.dump({ARCHS[k]: {"raw": _inputs()["raw"][k], "prompts": _inputs()["prompts"],
                                "force": force[k], "S": S} for k in ARCHS}, f)
    procs["ref_serve"] = (subprocess.Popen(
        [sys.executable, str(SERVE_REFERENCE), "--mesh", "2x2", "--inp", str(inp), "--out",
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ref_env),
        out)
    res = {"ref_grads": {k: _ref_grads(k) for k in ARCHS}}
    for key, (proc, out) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{key}: {err[-3000:]}"
        res[key] = dict(np.load(out))
    return res


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _rel(a, b) -> float:
    """max |a - b| over max |b| (a leaf's gradient against another's)."""
    return _gap(a, b) / max(float(np.abs(b).max()), 1e-30)


# -- (a) placements ------------------------------------------------------------------

class PortMesh:
    """The port's stand-in mesh: names, sizes and one rank's coordinate."""

    def __init__(self, d, m, coord=(0, 0)):
        self.mesh_dim_names = ("data", "model")
        self.shape = (d, m)
        self.coord = list(coord)

    def get_coordinate(self):
        return self.coord


def _sharders(short, d, m, kv=16, coord=(0, 0)):
    rcfg, tcfg = r_get_arch(ARCHS[short]).reduced(), get_arch(ARCHS[short]).reduced()
    if kv < 16:
        rcfg, tcfg = rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)
    r = rsh.Sharder(RefMesh(d, m), rcfg, replicate_params_below=0)
    r._ns = lambda *spec: tuple(spec)
    return r, tsh.Sharder(PortMesh(d, m, coord), tcfg, replicate_params_below=0)


def _axes_count(sharder, spec) -> int:
    return math.prod(sharder._axis_size(e) for e in spec or () if e is not None)


@pytest.mark.parametrize("d,m", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("short", sorted(ARCHS))
def test_param_placements_equal_reference(short, quantized, d, m):
    raw = _raw(short, quantized)
    port = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    r, t = _sharders(short, d, m)
    ref, got = _leaves(r.param_spec_tree(raw)), _leaves(t.param_spec_tree(port))
    assert ref.keys() == got.keys()
    assert got == ref
    if m > 1 and short != "mamba2":   # the expert stacks are cut on E
        assert any(v and v[1] == "model" for k, v in got.items() if "/ffn/w_gate" in k)
    if m > 1 and short != "moonshot":   # the conv's channels over "model"
        assert any(v == (None, None, "model") for k, v in got.items() if k.endswith("conv_w"))


@pytest.mark.parametrize("d,m", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("short,kv", [("mamba2", 16), ("jamba", 16), ("jamba", 4)])
def test_cache_placements_equal_reference(short, kv, d, m):
    """(mamba2 has no attention layer, so no k-bit KV cache.)"""
    r, t = _sharders(short, d, m, kv)
    for batch in (1, 2, 4):
        for per_slot in (True, False):
            rc = rlm.init_caches(r.cfg, batch, 24, per_slot=per_slot)
            tc = lm.init_caches(t.cfg, batch, 24, per_slot=per_slot, device="cpu")
            got, ref = _leaves(t.cache_spec_tree(tc, batch)), _leaves(r.cache_spec_tree(rc, batch))
            assert got == ref
            assert any(k.endswith("/state") for k in got)


@pytest.mark.parametrize("d,m", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("short", sorted(ARCHS))
def test_each_rank_stores_its_share(short, d, m):
    """Every rank's slices: the 4-bit tree as served (cut over "model": each
    field of a Placed leaf 1/tp of the whole field's bytes) and the dense
    train state (each leaf over the product of its axes' sizes)."""
    raw = jax.tree.map(np.asarray, _raw(short, True))
    q4 = interop.params_from_reference(raw, device="cpu")
    whole = _leaves(tsh.Sharder(PortMesh(d, m), get_arch(ARCHS[short]).reduced(),
                                replicate_params_below=0).param_spec_tree(q4))
    n_cut = 0
    for coord in [(i, j) for i in range(d) for j in range(m)]:
        _, t = _sharders(short, d, m, coord=coord)
        placed = t.shard_params(q4)
        for (key, spec), (_, leaf), (_, mine) in zip(whole.items(), _tensors(q4).items(),
                                                     _tensors(placed).items(), strict=True):
            count = 1 if spec is None else math.prod(
                t._axis_size(e) for e in spec if e is not None and "model" in ops.axis_names(e))
            assert mine.numel() * count == leaf.numel(), key
            n_cut += count > 1
    assert n_cut or m == 1
    _, t = _sharders(short, d, m)
    pl = t.train_placement()
    for shape, local, spec in zip(pl.shapes, pl.local_shapes, pl.specs, strict=True):
        assert math.prod(local) * _axes_count(t, spec) == math.prod(shape)


def _tensors(tree, prefix=""):
    """{path: tensor} of a params tree, a QuantizedTensor's (or a Placed
    slice's) fields as leaves, in ``_leaves``' order."""
    if isinstance(tree, ops.Placed):
        tree = tree.local
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _tensors(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _tensors(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, QuantizedTensor):
        return {f"{prefix}.{f}": getattr(tree, f) if getattr(tree, f) is not None
                else torch.zeros(0) for f in QT_FIELDS}
    return {prefix: tree}


# -- (b) the MoE layer alone -----------------------------------------------------------

@pytest.mark.parametrize("case", ["g16", "g1", "masked", "decode"])
@pytest.mark.parametrize("tree", ["dense", "q4", "q4dq"])
@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_moe_layer_serving_bit_for_bit(runs, mesh, tree, case):
    w = runs[mesh]
    key = f"moe_serve_{tree}_{case}"
    assert bool(w[key + "_equal"]), float(w[key + "_gap"])


@pytest.mark.parametrize("case", ["g1", "g16"])
@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_moe_layer_training_keeps_capacity_and_drops(runs, mesh, case):
    w = runs[mesh]
    p, m = f"moe_train_{case}_plain", f"moe_train_{case}_mesh"
    assert int(w[p + "_dropped"]) > 0     # the capacity drops tokens
    assert abs(float(w[m + "_loss"]) - float(w[p + "_loss"])) < LOSS_BAR
    grads = [k[len(p):] for k in w if k.startswith(p + "_g")]
    assert "_gx" in grads and any("router" in k for k in grads)
    for k in grads:
        assert _rel(w[m + k], w[p + k]) < GRAD_BAR, k


# -- (c) the SSM layer alone -------------------------------------------------------------

@pytest.mark.parametrize("variant", ["base", "whole_heads", "groups"])
@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_ssm_layer_within_dense_bar(runs, mesh, variant):
    w = runs[mesh]
    key = f"ssm_{variant}"
    # 6 heads stay whole on a 4-way "model" axis; every other case splits them
    assert bool(w[key + "_heads_split"]) == (not (variant == "whole_heads" and mesh == "1x4"))
    for part in ("seq", "tail", "decode", "cache"):
        assert float(w[f"{key}_{part}_gap"]) < BF16_BAR, part


# -- (d) whole models ----------------------------------------------------------------------

@pytest.mark.parametrize("short", sorted(ARCHS))
def test_model_served_within_bars(runs, short, record_property):
    """On the rows whose routes agree with the unsharded run's (every row
    where no router flips): the sharded logits' gap to the port's unsharded
    ones at most the reference's own 2x2 sharded rollout's gap to its
    unsharded one plus 0.08 (the sequence-sharded combine's roundings grow
    through jamba's 16 layers: 0.15 here, the reference's own 2.4), and
    their gap to the reference's unsharded ones at most the port's
    unsharded gap plus the same."""
    w, ref = runs["2x2"], runs["ref_serve"]
    flips = w.get(f"{short}_route_flips")
    record_property("route_flips", None if flips is None else flips.tolist())
    rows = ~w.get(f"{short}_flipped_rows", np.zeros(B, dtype=bool))
    record_property("same_route_rows", int(rows.sum()))
    assert rows.any(), flips
    mine, plain = w[f"{short}_logits"][rows], w[f"{short}_port_logits"][rows]
    ref_plain = ref[f"{ARCHS[short]}_plain"][rows]
    bar = _gap(ref[f"{ARCHS[short]}_sharded"], ref[f"{ARCHS[short]}_plain"]) + BF16_BAR
    record_property("reference_sharded_gap", bar - BF16_BAR)
    assert _gap(mine, plain) < bar, flips
    assert _gap(mine, ref_plain) < _gap(plain, ref_plain) + bar, flips


@pytest.mark.parametrize("short,slots", [("jamba", 1), ("mamba2", 1), ("mamba2", 2),
                                         ("moonshot", 1)])
def test_model_server_equals_engine_on_mesh(runs, short, slots):
    """A pool of one slot decodes with the batch-1 Engine's plan; mamba2's
    pool of 2 splits its rows over "data" (its SSM caches written through
    ``local_row``)."""
    assert runs["2x2"][f"{short}_server{slots}_engine_match"].all()


def _train_gaps(w, short, want_loss, want):
    """(loss gap, worst leaf and its gap) of a world's sharded step against
    another step's loss and {keystr: gradient}."""
    p = f"{short}_train_mesh_g"
    gaps = {k: _rel(w[p + k], g) for k, g in want.items()}
    worst = max(gaps, key=gaps.get)
    return abs(float(w[f"{short}_train_mesh_loss"]) - want_loss), worst, gaps[worst]


@pytest.mark.parametrize("short,mesh", [("moonshot", "2x2"), ("mamba2", "2x2"),
                                        ("jamba", "2x2"), ("moonshot", "1x4")])
def test_model_trained_within_bars(runs, short, mesh, record_property):
    w = runs[mesh]
    flips = w.get(f"{short}_train_route_flips")
    record_property("route_flips", None if flips is None else flips.tolist())
    plain = {k[len(f"{short}_train_plain_g"):]: v for k, v in w.items()
             if k.startswith(f"{short}_train_plain_g")}
    loss = float(w[f"{short}_train_plain_loss"])
    dl, leaf, dg = _train_gaps(w, short, loss, plain)
    assert dl < LOSS_BAR, (dl, flips)
    assert dg < GRAD_BAR, (leaf, dg, flips)
    # the reference's unsharded step: at most the port's unsharded gap to it
    # plus the bars (jamba's port and reference steps differ by more than
    # the bars before any mesh: ROADMAP queue C)
    ref_loss, ref = runs["ref_grads"][short]
    assert ref.keys() == plain.keys()
    port_gaps = {k: _rel(plain[k], g) for k, g in ref.items()}
    record_property("port_unsharded_vs_reference", {
        "loss": abs(loss - ref_loss), "worst_leaf": max(port_gaps, key=port_gaps.get),
        "worst_rel": max(port_gaps.values())})
    assert (abs(float(w[f"{short}_train_mesh_loss"]) - ref_loss)
            < abs(loss - ref_loss) + LOSS_BAR)
    for k, g in ref.items():
        assert _rel(w[f"{short}_train_mesh_g" + k], g) < _rel(plain[k], g) + GRAD_BAR, k


@pytest.mark.parametrize("short", sorted(REF_SHARDED))
def test_model_trained_within_reference_sharded_step(runs, short):
    """mamba2 at 2x2 and moonshot at 1x4 against the reference's own sharded
    step on the same mesh, the same bars."""
    mesh = REF_SHARDED[short]
    ref = runs[f"ref_{short}"]
    grads = {k: v for k, v in ref.items() if k != "loss"}
    dl, leaf, dg = _train_gaps(runs[mesh], short, float(ref["loss"]), grads)
    assert dl < LOSS_BAR, dl
    assert dg < GRAD_BAR, (leaf, dg)


# -- the refusals that stay -------------------------------------------------------------

def test_attention_free_arch_passes_the_kv_gate_on_a_mesh():
    """mamba2 has no attention layer, so a k-bit cache setting lays out no
    K/V row and the mesh's gate lets it through (the reference divides by
    its zero-width row there)."""
    cfg = get_arch("mamba2-130m").reduced().with_kv_quant(4)
    s = tsh.Sharder(PortMesh(1, 2), cfg, replicate_params_below=0)
    tsh.check_decode_capability(cfg, s, caller="the test")


def test_mesh_still_refuses_the_encoder_decoder_and_takes_the_rest():
    """A Sharder on a mesh takes moonshot, phi3.5-moe, mamba2 and jamba and,
    since the encoder-decoder's slice of A11.2, seamless too, and places
    their trees (``tests/test_torch_encdec_mesh.py`` holds seamless's
    placements to the reference's)."""
    from repro_torch.models import seq2seq

    for name in ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "mamba2-130m",
                 "jamba-v0.1-52b", "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(get_arch(name).reduced(), name=name)
        init = seq2seq.init_params if cfg.encoder_decoder else lm.init_params
        specs = _leaves(tsh.Sharder(PortMesh(1, 2), cfg, replicate_params_below=0)
                        .param_spec_tree(init(cfg, device="meta")))
        assert any(v and "model" in v for v in specs.values()), name
