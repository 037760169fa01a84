"""Serving on a mesh of ranks (``models/sharding.py``), on the CPU: gloo
worlds of 2 (a 1x2 ("data", "model") mesh) and 4 (2x2, and 1x4 for the
variants alone), mirroring
``tests/test_sharded_serving.py`` case by case on tiny-650k (4 heads), B 4,
Sp 8, S 24.

Each world is spawned once (``tests/torch_mesh_worker.py``, which imports no
JAX: one process a rank, one thread each) and runs every check; its
numbers come back as numpy, and each test below asserts one check on them:

* bf16: the sharded teacher-forced logits within 0.08 of the reference's
  unsharded rollout (compiled without excess precision) and of the port's
  own (the row-parallel partial sums and the flash-decoding combine move
  the bf16 roundings);
* kv8 and kv4: the sharded packed-cache logits within ``KV_LOGIT_TOL`` of
  the reference's unsharded bf16 oracle (the reference's own unsharded kv
  gaps on this config are inside it too);
* fused = dequant_einsum under TP: greedy tokens identical, logits within
  0.05, and within 0.08 of the unsharded dequant_einsum oracle (the
  reference's and the port's);
* Engine = Server (one slot) per request at kv4, tokens identical;
* a ring window that does not divide the sequence grid falls back with a
  ``SeqShardFallbackWarning`` at setup and in the rollout
  (``seq_shard_plan == {5: False}``) within 0.08 of the reference.  The
  reference's test uses a window of 6 on its 2x4 mesh, whose 4-way model
  axis 6 does not divide; at these worlds the grid is 2-way and 6 divides
  it, so the fallback case takes 5 and the window of 6 is the added case
  of a ring sequence-sharded (no warning, ``{6: True}``, the same bar);
* two variants on the sharded GQA path (``VARIANTS``: KV groups of 2, and
  6 q heads over 3 KV heads, both with an untied head) in those worlds and
  a 1x4 one: bf16 within 0.08 of the reference's unsharded rollout of
  the same variant; kv4 within the reference's own unsharded kv4 gap plus
  0.08 (that gap misses ``KV_LOGIT_TOL`` on these variants) and within
  ``KV_LOGIT_TOL`` of the reference's kv4 rollout; fused = dequant_einsum
  under TP within the bars above;
* the port's own: the 2-slot Server on the mesh gives the unsharded
  Server's tokens (kv4, 4-bit weights), and ``launch/serve.py --mesh 1x2``
  under ``torchrun --standalone --nproc-per-node 2`` exits 0.

Tokens fed to the teacher-forced rollouts are the port's unsharded greedy
ones, on both sides.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro_torch.serving import KV_LOGIT_TOL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
ARCH, B, SP, S, N = "tiny-650k", 4, 8, 24, 12
NO_EXCESS = {"xla_allow_excess_precision": False}
BF16_BAR = 0.08


#: variants of tiny-650k on the sharded GQA path, the same overrides on
#: both sides: "gqa", KV groups of 2 (a rank holds whole groups on a 2-way
#: model axis, heads of one group on a 4-way one) and an untied
#: vocab-parallel head; "pad", 6 q heads over 3 KV heads (a rank's heads
#: read their KV heads by index_select on a 2- and a 4-way model axis, and
#: the 4-way one pads them to 12 inside the KV groups), untied
VARIANTS = {"gqa": dict(n_kv_heads=2, tie_embeddings=False),
            "pad": dict(n_heads=6, n_kv_heads=3, tie_embeddings=False)}
#: head_pad() of each variant by mesh
HEAD_PAD = {"gqa": {"1x2": 4, "2x2": 4, "1x4": 4}, "pad": {"1x2": 6, "2x2": 6, "1x4": 12}}


def _rcfg(variant: str = ""):
    cfg = r_get_arch(ARCH)
    return dataclasses.replace(cfg, **VARIANTS[variant]) if variant else cfg


@functools.lru_cache(maxsize=None)
def _reference(variant: str = ""):
    """(the reference's init of tiny-650k or a variant, its 4-bit float b64
    quantization, the prompts [B, Sp] from a numpy seed)."""
    rcfg = _rcfg(variant)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    qraw = r_quantize_params(raw, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg)
    toks = np.random.RandomState(1).randint(0, rcfg.vocab_size, (B, SP)).astype(np.int32)
    return raw, qraw, toks


@functools.lru_cache(maxsize=None)
def _ref_logits(kind: str, force: bytes, variant: str = "") -> np.ndarray:
    """The reference's unsharded logits [B, N, V], teacher-forced on
    ``force`` (int32 [B, N] as bytes): "bf16", "kv4" (a 4-bit KV cache),
    "dequant" (the 4-bit tree in dequant_einsum mode) or "ring<w>" (every
    layer a ring of w), of tiny-650k or ``variant``."""
    raw, qraw, toks = _reference(variant)
    cfg, params = _rcfg(variant), raw
    if kind == "dequant":
        cfg, params = cfg.with_matmul_mode("dequant_einsum"), qraw
    elif kind == "kv4":
        cfg = cfg.with_kv_quant(4)
    elif kind.startswith("ring"):
        cfg = dataclasses.replace(cfg, sliding_window=int(kind[4:]))
    fed = np.frombuffer(force, dtype=np.int32).reshape(B, N)
    jit = functools.partial(jax.jit, compiler_options=NO_EXCESS)
    pf = jit(lambda p, t: rlm.prefill(p, t, cfg, cache_len=S))
    dec = jit(lambda p, tok, c, pos: rlm.decode_step(p, tok, c, pos, cfg))
    logits, caches = pf(params, jnp.asarray(toks))
    logs = [np.asarray(logits, np.float32)]
    for t in range(N - 1):
        logits, caches = dec(params, jnp.asarray(fed[:, t]), caches, jnp.int32(SP + t))
        logs.append(np.asarray(logits, np.float32))
    return np.stack(logs, 1)


def _ref(kind, force, variant=""):
    return _ref_logits(kind, np.ascontiguousarray(force, dtype=np.int32).tobytes(), variant)


#: mesh -> the numbers of its one gloo world
_WORLDS: dict = {}


def _spawn(mesh: str, tmp_path_factory, *, main: bool) -> dict:
    """Every check's numbers from one gloo world of the mesh's size (the
    main checks when ``main``, the variants' always), spawned once."""
    if mesh not in _WORLDS:
        raw, _, toks = _reference()
        variants = {name: (ov, jax.tree.map(np.asarray, _reference(name)[0]))
                    for name, ov in VARIANTS.items()}
        d = tmp_path_factory.mktemp(f"mesh{mesh}")
        inp, out = d / "in.pkl", d / "out.npz"
        with open(inp, "wb") as f:
            pickle.dump({"raw": jax.tree.map(np.asarray, raw), "toks": toks, "n": N, "S": S,
                         "main": main, "variants": variants}, f)
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        res = subprocess.run([sys.executable, str(WORKER), "--mesh", mesh, "--inp", str(inp),
                              "--out", str(out)], capture_output=True, text=True, timeout=600,
                             env=env)
        assert res.returncode == 0, res.stderr[-3000:]
        _WORLDS[mesh] = dict(np.load(out))
    return _WORLDS[mesh]


@pytest.fixture(scope="module", params=["1x2", "2x2"])
def world(request, tmp_path_factory):
    return _spawn(request.param, tmp_path_factory, main=True)


@pytest.fixture(scope="module", params=["1x2", "2x2", "1x4"])
def variant_world(request, tmp_path_factory):
    """(mesh, numbers): the worlds above, and a 1x4 world of the variants alone."""
    return request.param, _spawn(request.param, tmp_path_factory,
                                 main=request.param != "1x4")


def _gap(a, b) -> float:
    return float(np.abs(a - b).max())


def test_sharded_bf16_within_combine_noise(world):
    ref = _ref("bf16", world["force"])
    assert _gap(world["bf16_logits"], ref) < BF16_BAR
    assert _gap(world["bf16_logits"], world["port_bf16_logits"]) < BF16_BAR


@pytest.mark.parametrize("bits", [8, 4])
def test_sharded_kv_within_kv_logit_tol(world, bits):
    ref = _ref("bf16", world["force"])
    gap = _gap(world[f"kv{bits}_logits"], ref)
    assert gap < KV_LOGIT_TOL[bits], gap
    # the port's unsharded packed cache is inside the same bar
    assert _gap(world[f"port_kv{bits}_logits"], ref) < KV_LOGIT_TOL[bits]


def test_fused_matches_dequant_under_tp(world):
    assert np.array_equal(world["tf"], world["td"])
    assert _gap(world["lf"], world["ld"]) < 0.05


def test_fused_within_unsharded_dequant_oracle(world):
    assert _gap(world["lf"], _ref("dequant", world["tf"])) < BF16_BAR
    assert _gap(world["lf"], world["port_l1"]) < BF16_BAR


def test_engine_matches_server_on_mesh_kv4(world):
    assert world["engine_server_match"].all(), world["engine_server_match"]


def test_ring_cache_falls_back_with_warning_and_stays_correct(world):
    assert world["ring5_setup_warned"] and world["ring5_rollout_warned"]
    assert world["ring5_plan"].tolist() == [[5, 0]]
    assert _gap(world["ring5_logits"], _ref("ring5", world["ring5_force"])) < BF16_BAR


def test_ring_cache_sequence_sharded_when_it_divides(world):
    assert not world["ring6_setup_warned"] and not world["ring6_rollout_warned"]
    assert world["ring6_plan"].tolist() == [[6, 1]]
    assert _gap(world["ring6_logits"], _ref("ring6", world["ring6_force"])) < BF16_BAR


def test_mesh_server_matches_unsharded_server(world):
    assert np.array_equal(world["server_mesh"], world["server_plain"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_sharded_bf16_within_combine_noise(variant_world, variant):
    mesh, w = variant_world
    assert int(w[f"{variant}_head_pad"]) == HEAD_PAD[variant][mesh]
    ref = _ref("bf16", w[f"{variant}_force"], variant)
    assert _gap(w[f"{variant}_bf16_logits"], ref) < BF16_BAR


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_sharded_kv4_within_reference_gap(variant_world, variant):
    """The reference's own unsharded kv4 gap on these variants misses
    ``KV_LOGIT_TOL[4]`` (2.6-2.8 against 1.0), so the sharded kv4 rollout is
    held to that gap (plus the bf16 bar) and, like for like, to the
    reference's unsharded kv4 rollout within ``KV_LOGIT_TOL[4]``."""
    _, w = variant_world
    ref, ref4 = (_ref(k, w[f"{variant}_force"], variant) for k in ("bf16", "kv4"))
    assert _gap(w[f"{variant}_kv4_logits"], ref) < _gap(ref4, ref) + BF16_BAR
    assert _gap(w[f"{variant}_kv4_logits"], ref4) < KV_LOGIT_TOL[4]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_fused_matches_dequant_under_tp(variant_world, variant):
    _, w = variant_world
    assert np.array_equal(w[f"{variant}_tf"], w[f"{variant}_td"])
    assert _gap(w[f"{variant}_lf"], w[f"{variant}_ld"]) < 0.05
    assert _gap(w[f"{variant}_lf"], _ref("dequant", w[f"{variant}_tf"], variant)) < BF16_BAR


def test_launch_serve_mesh_under_torchrun(tmp_path):
    """torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve
    --mesh 1x2 --kv-bits 4 --device cpu exits 0 and serves every request."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", "--arch",
                          ARCH, "--mesh", "1x2", "--kv-bits", "4", "--num-requests", "4",
                          "--num-slots", "2", "--max-new", "6", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh: {'data': 1, 'model': 2}" in res.stdout
    assert "served 4 requests" in res.stdout
