"""The port's step profiler (``serving/profiler.py``, ``utils/cost.py``)
against the reference's, on the CPU.

Mirrors the profiler cases of ``tests/test_observatory.py`` (costing,
attribution and export; the roofline math and the null annotation; sticky
failure; greedy tokens with the profiler on and off, also for the chunked,
paged and preempting Servers), and adds:

* a 64 x 64 f32 product costs exactly 2 * 64**3 FLOPs in both packages;
* the dot FLOPs of tiny-160k's ``prefill[2x7]`` and ``decode_step[2]``
  (``max_seq_len`` 14) equal the reference's, read live from its compiled
  programs with ``repro.utils.hlo``'s parser counting only ``dot`` ops
  (times their loops' trip counts), at bf16 and 4-bit float b64 weights
  and at kv16 and kv4 — 3,556,352 and 964,608, the analytic counts;
* the port's ``hbm_bytes`` of ``decode_step[2]`` is at least the stored
  bytes of the weights and caches the step reads (printed beside the
  reference's HLO bytes, which count XLA's fusion boundaries);
* costing leaves the serving caches, the generator and the launch
  counters as they were;
* the cost rules: views free, gathers read what they output, partial
  in-place writes count what they write, charged units hide their inside.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving.profiler import StepProfiler as RStepProfiler  # noqa: E402
from repro.serving.telemetry import MetricsRegistry as RMetricsRegistry  # noqa: E402
from repro.utils import hlo  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels import quantize as quantize_mod  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.serving import NOOP, Engine, Server, StepProfiler, Telemetry  # noqa: E402
from repro_torch.serving.profiler import ProgramCost, null_annotation  # noqa: E402
from repro_torch.serving.telemetry import MetricsRegistry  # noqa: E402
from repro_torch.utils import cost  # noqa: E402

torch.set_num_threads(2)

NAME = "tiny-160k"
#: the analytic dot FLOPs of tiny-160k's programs at max_seq_len 14 (the
#: reference's, read from its HLO below): prefill[2x7] is 14 rows through
#: the layers, the head on the last row of each prompt and the 7 x 7
#: attention; decode_step[2] two rows through the layers and the head, and
#: q·kᵀ and p·v over all 14 cache slots
PREFILL_DOTS, STEP_DOTS = 3_556_352, 964_608
B, S, NEW, CACHE = 2, 7, 5, 14


def _prompts(batch, length, seed):
    return np.random.RandomState(seed).randint(0, 2048, (batch, length))


@functools.lru_cache(maxsize=None)
def _weights(weights):
    """(reference tree, port tree) from the reference's PRNGKey(0) init."""
    rcfg, tcfg = r_get_arch(NAME), get_arch(NAME)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    port = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    if weights == "w16":
        return raw, port
    return (r_quantize_params(raw, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg),
            quantize_params(port, QuantConfig(bits=4, dtype="float", block_size=64), tcfg,
                            device="cpu"))


def _cfgs(kv):
    rcfg, tcfg = r_get_arch(NAME), get_arch(NAME)
    if kv < 16:
        return rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)
    return rcfg, tcfg


def _hlo_dot_flops(text: str) -> float:
    """2·M·N·K over the ``dot`` (and ``convolution``) ops of a compiled
    program, fused or not, times the trip counts of their loops."""
    comps = hlo._parse_computations(text)
    memo: dict[str, float] = {}

    def walk(name):
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        comp = comps.get(name)
        total = 0.0
        for op in comp.ops if comp is not None else ():
            if op.opcode == "while":
                trip = hlo._trip_count(op.line)
                for key in ("body", "condition"):
                    m = re.search(key + r"=%?([\w\.\-]+)", op.line)
                    if m:
                        total += walk(m.group(1)) * trip
            elif op.opcode == "conditional":
                total += max([walk(b) for b in hlo._called(op.line)] or [0.0])
            elif op.opcode in ("dot", "convolution"):
                total += hlo._dot_flops(op, comp)
            else:
                total += sum(walk(c) for c in hlo._called(op.line))
        memo[name] = total
        return total

    return walk(re.search(r"^ENTRY\s+%?([\w\.\-]+)", text, re.M).group(1))


@functools.lru_cache(maxsize=None)
def _reference_costs(weights, kv):
    """The reference Engine's prefill[2x7] and decode_step[2], compiled as
    its profiler compiles them: (dot FLOPs each, the step's HLO bytes)."""
    rcfg, _ = _cfgs(kv)
    params, _ = _weights(weights)
    eng = REngine(params, rcfg, max_seq_len=CACHE)
    prompts = jnp.asarray(_prompts(B, S, 80), jnp.int32)
    prefill = eng._prefill.lower(params, prompts).compile()
    _, caches = eng._prefill(params, prompts)
    step = eng._step.lower(params, jnp.zeros((B,), jnp.int32), caches, jnp.int32(S),
                           jax.random.PRNGKey(1), jnp.float32(0.0),
                           jnp.zeros((B,), bool)).compile()
    return (_hlo_dot_flops(prefill.as_text()), _hlo_dot_flops(step.as_text()),
            hlo.compiled_cost(step)["hbm_bytes"])


@functools.lru_cache(maxsize=None)
def _port_engine_costs(weights, kv):
    _, tcfg = _cfgs(kv)
    _, params = _weights(weights)
    tel = Telemetry(profiler=StepProfiler())
    out = Engine(params, tcfg, max_seq_len=CACHE, telemetry=tel,
                 device="cpu").generate(_prompts(B, S, 80), NEW)
    (session,) = tel.profiler.sessions
    return session.costs, out, params, tcfg


# -------------------------------------------------------------------------
# the reference's profiler cases (tests/test_observatory.py)
# -------------------------------------------------------------------------

def test_profiler_costs_attributes_and_exports():
    prof = StepProfiler(peak_flops=1e12, hbm_bw=1e11)
    reg = MetricsRegistry()
    sess = prof.session(reg, kv_bits="16", matmul_mode="auto")
    args = (torch.ones((64, 64)), torch.ones((64, 64)))
    pc = sess.ensure_costed("dot[64]", torch.matmul, args)
    assert pc is not None
    assert pc.flops == pc.dot_flops == 2 * 64 ** 3   # the product, nothing else
    assert pc.hbm_bytes == 3 * 64 * 64 * 4 and pc.cost_s > 0
    assert pc.kernel_flops == 0 and pc.collective_bytes == 0
    # idempotent: the cost cache returns the same object, no second run
    assert sess.ensure_costed("dot[64]", torch.matmul, args) is pc

    with sess.annotation("dot[64]"):
        torch.matmul(*args)
    sess.observe("dot[64]", 1e-3)
    txt = reg.prometheus_text()
    for fam in ("profile_program_flops", "profile_program_hbm_bytes",
                "profile_achieved_flops_per_s", "profile_achieved_hbm_gbps",
                "profile_roofline_frac"):
        assert fam in txt, fam
    assert 'program="dot[64]"' in txt
    frac = reg.gauge("profile_roofline_frac", kv_bits="16", matmul_mode="auto",
                     program="dot[64]").value
    assert frac == pytest.approx(pc.roofline_seconds(1e12, 1e11) / 1e-3)

    rows = prof.summary()
    assert len(rows) == 1 and rows[0]["program"] == "dot[64]"
    assert rows[0]["calls"] == 1 and rows[0]["dot_flops"] == 2 * 64 ** 3
    assert "dot[64]" in prof.format_summary()


def test_dot_product_costs_the_same_in_both_packages():
    """A 64 x 64 f32 product: exactly 2 * 64**3 = 524,288 FLOPs in both."""
    r_sess = RStepProfiler(peak_flops=1e12, hbm_bw=1e11).session(RMetricsRegistry())
    r_pc = r_sess.ensure_costed("dot[64]", jax.jit(lambda a, b: a @ b),
                                (jnp.ones((64, 64), jnp.float32),
                                 jnp.ones((64, 64), jnp.float32)))
    sess = StepProfiler().session(MetricsRegistry())
    pc = sess.ensure_costed("dot[64]", torch.matmul,
                            (torch.ones((64, 64)), torch.ones((64, 64))))
    assert r_pc.flops == pc.flops == 524_288


def test_profiler_roofline_math_and_null_annotation():
    pc = ProgramCost(name="x", flops=2e9, dot_flops=2e9, hbm_bytes=1e8, collective_bytes=0.0,
                     kernel_flops=0.0, kernel_bytes=0.0, cost_s=0.0)
    # compute-bound at these peaks: 2e9/1e12 = 2ms > 1e8/1e12 s
    assert pc.roofline_seconds(1e12, 1e12) == pytest.approx(2e-3)
    # memory-bound when bandwidth is the binding term
    assert pc.roofline_seconds(1e15, 1e9) == pytest.approx(0.1)
    with null_annotation("anything"):
        pass
    assert NOOP.profiler is None
    # the default peaks are the H100 SXM's
    prof = StepProfiler()
    assert (prof.peak_flops, prof.hbm_bw) == (device_mod.PEAK_FLOPS_BF16, device_mod.HBM_BW)
    assert (prof.peak_flops, prof.hbm_bw) == (989e12, 3.35e12)


def test_profiler_failure_is_sticky_and_warns():
    prof = StepProfiler(peak_flops=1e12, hbm_bw=1e11)
    sess = prof.session(MetricsRegistry(), kv_bits="16", matmul_mode="auto")
    runs = []

    def boom():
        runs.append(1)
        raise RuntimeError("no costing today")

    with pytest.warns(UserWarning, match="could not cost 'bad'"):
        assert sess.ensure_costed("bad", boom, ()) is None
    # sticky: the second call neither retries nor warns again
    assert sess.ensure_costed("bad", boom, ()) is None
    assert len(runs) == 1
    sess.observe("bad", 1e-3)  # uncosted observe is histogram-only
    assert sess.summary() == []


def _serve(params, cfg, prompts, budgets, telemetry, **kw):
    srv = Server(params, cfg, num_slots=2, max_seq_len=32, telemetry=telemetry, device="cpu",
                 **kw)
    n = len(prompts)
    classes = kw.get("max_preemptions", 0) > 0
    ids = [srv.submit(p, m, arrival_time=1.0 * i,
                      priority=(1 if classes and i < n // 2 else 0),
                      temperature=0.8 if i == 1 else 0.0)
           for i, (p, m) in enumerate(zip(prompts, budgets))]
    res = srv.run_until_drained()
    return [res[r] for r in ids], srv


@pytest.mark.parametrize("variant,kw,programs", [
    ("slots", {}, ("prefill[", "decode_step")),
    ("chunked", {"prefill_chunk": 8}, ("prefill_chunk[", "chunk_commit[", "decode_step")),
    ("paged", {"paged": True, "page_size": 8}, ("prefill_paged[", "decode_step")),
    ("preempt", {"max_preemptions": 2}, ("prefill[", "decode_step")),
])
def test_tokens_identical_with_profiler_on_vs_off(variant, kw, programs):
    """The acceptance criterion: attaching the profiler changes no token
    (greedy, and a sampled request: the generator's state is put back after
    each costing) and the profiled run attributes the real programs."""
    cfg = get_arch(NAME).with_kv_quant(4)
    _, params = _weights("q4")
    lens, budgets = [10, 6, 20, 8], [6, 4, 5, 7]
    prompts = [_prompts(1, L, seed=70 + i)[0] for i, L in enumerate(lens)]
    tel = Telemetry(profiler=StepProfiler())
    on, srv = _serve(params, cfg, prompts, budgets, tel, **kw)
    off, _ = _serve(params, cfg, prompts, budgets, NOOP, **kw)
    assert on == off
    if variant == "preempt":
        assert srv.scheduler.n_preemptions > 0
    rows = tel.profiler.summary()
    names = {r["program"] for r in rows}
    for prefix in programs:
        assert any(n.startswith(prefix) for n in names), (prefix, names)
    assert all(r["roofline_frac"] > 0 and r["flops"] > 0 for r in rows)
    assert "profile_roofline_frac" in tel.registry.prometheus_text()


@pytest.mark.parametrize("kv", [16, 4])
def test_engine_tokens_identical_with_profiler_on_vs_off(kv):
    """The static Engine: same contract, greedy and sampled."""
    _, cfg = _cfgs(kv)
    _, params = _weights("q4")
    prompts = _prompts(B, S, 80)
    tel = Telemetry(profiler=StepProfiler())
    for temperature in (0.0, 0.9):
        g_on, g_off = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
        on = Engine(params, cfg, max_seq_len=CACHE, telemetry=tel,
                    device="cpu").generate(prompts, NEW, temperature=temperature, generator=g_on)
        off = Engine(params, cfg, max_seq_len=CACHE, device="cpu").generate(
            prompts, NEW, temperature=temperature, generator=g_off)
        assert torch.equal(on, off)
        assert torch.equal(g_on.get_state(), g_off.get_state())
    names = {r["program"] for r in tel.profiler.summary()}
    assert names == {f"prefill[{B}x{S}]", f"decode_step[{B}]"}


# -------------------------------------------------------------------------
# parity of the counts with the reference's programs
# -------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [16, 4])
@pytest.mark.parametrize("weights", ["w16", "q4"])
def test_dot_flops_equal_reference(weights, kv):
    """The parity bar: the port's dot FLOPs are the reference's, whatever
    the weight or cache width (the totals and bytes depend on XLA's fusion
    and on the dequant's elementwise work, so they are held to floors)."""
    r_prefill, r_step, _ = _reference_costs(weights, kv)
    assert (r_prefill, r_step) == (PREFILL_DOTS, STEP_DOTS)
    costs, out, _, _ = _port_engine_costs(weights, kv)
    assert costs[f"prefill[{B}x{S}]"].dot_flops == PREFILL_DOTS
    assert costs[f"decode_step[{B}]"].dot_flops == STEP_DOTS
    for pc in costs.values():
        assert pc.flops > pc.dot_flops and pc.kernel_flops >= pc.dot_flops
        assert pc.hbm_bytes >= pc.kernel_bytes > 0


@pytest.mark.parametrize("kv", [16, 4])
@pytest.mark.parametrize("weights", ["w16", "q4"])
def test_decode_step_bytes_cover_the_stored_weights_and_caches(weights, kv, capsys):
    """decode_step[2] reads every matrix and the whole cache of every layer
    as stored: its bytes are at least theirs."""
    costs, _, params, cfg = _port_engine_costs(weights, kv)
    pc = costs[f"decode_step[{B}]"]
    stored = sum(cost.nbytes(t) for t in interop.flatten(params).values())
    caches = Engine(params, cfg, max_seq_len=CACHE, device="cpu")._prefill(
        torch.as_tensor(_prompts(B, S, 80)))[1]
    stored += sum(cost.nbytes(t) for c in caches for t in c.values())
    assert pc.hbm_bytes >= stored, (pc.hbm_bytes, stored)
    _, _, r_bytes = _reference_costs(weights, kv)
    with capsys.disabled():
        print(f"\ndecode_step[2] {weights}/kv{kv}: port {pc.hbm_bytes:.0f} bytes "
              f"(stored {stored}), reference HLO {r_bytes:.0f}")


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for ca, cb in zip(a, b) for x, y in
               zip((ca[k] for k in sorted(ca)), (cb[k] for k in sorted(cb))))


def test_costing_leaves_caches_generator_and_counters_unchanged():
    cfg = get_arch(NAME).with_kv_quant(4)
    _, params = _weights("q4")
    srv = Server(params, cfg, num_slots=2, max_seq_len=32, device="cpu",
                 telemetry=Telemetry(profiler=StepProfiler()))
    srv.submit(_prompts(1, 9, 5)[0], 6, temperature=0.7)
    srv.step()   # one admission and one decode step, both costed
    before = [{k: v.clone() for k, v in c.items()} for c in srv.pool.caches]
    state = srv._gen.get_state()
    srv._tok.fill_(3)
    srv._cost("decode_step[again]", srv._decode_program, srv.pool.caches)
    assert _leaves_equal(before, srv.pool.caches)
    assert torch.equal(state, srv._gen.get_state())
    # measure takes a run's launches back from the kernels' counters
    counts = launches.snapshot()

    def launching():
        quantize_mod.quantize_pack_cuda.launches += 2
        return torch.ones(3) * 2

    pc = cost.measure("launching", launching)
    assert launches.snapshot() == counts and pc.flops == 3


# -------------------------------------------------------------------------
# the cost rules (utils/cost.py)
# -------------------------------------------------------------------------

def test_cost_rules_views_gathers_and_partial_writes():
    cache = torch.zeros((4, 100, 8), dtype=torch.bfloat16)
    # views cost nothing
    pc = cost.measure("views", lambda: cache.reshape(400, 8)[:, 2:].permute(1, 0).T)
    assert (pc.flops, pc.hbm_bytes) == (0, 0)
    # a one-row write costs the row and its indices, not the cache
    rows, slots = torch.arange(4), torch.tensor([5, 6, 7, 8])
    val = torch.ones((4, 8), dtype=torch.bfloat16)
    pc = cost.measure("write", lambda: cache.index_put_((rows, slots), val))
    assert pc.hbm_bytes == 2 * 4 * 8 + 2 * 4 * 8 + 2 * 4 * 8 and pc.flops == 32
    pc = cost.measure("slice", lambda: cache[:, :3].copy_(torch.zeros((4, 3, 8))))
    assert pc.hbm_bytes == 4 * 3 * 8 * 4 * 2 + 4 * 3 * 8 * 2 and pc.flops == 0
    # a gather reads what it outputs, not the table
    table = torch.ones((1000, 16))
    pc = cost.measure("gather", lambda: table[torch.tensor([1, 2])])
    assert pc.hbm_bytes == 2 * (2 * 16 * 4) + 2 * 8 and pc.flops == 32
    # an elementwise op: one FLOP an output element, inputs and output moved
    a = torch.ones((10, 10))
    pc = cost.measure("ew", lambda: a * a + 1)
    assert pc.flops == 200 and pc.hbm_bytes == 2 * (400 + 400)


def test_charged_units_hide_their_inside():
    """B1 charges 2·M·N·K over x's own width and the stored operands; the
    plain version's ops inside it are not counted."""
    from repro_torch.kernels import ops

    w = torch.randn((200, 96), generator=torch.Generator().manual_seed(0))
    op = ops.prepare_operand(w, bits=4, dtype="float", block_size=64)   # K padded to 256
    x = torch.randn((3, 200), dtype=torch.bfloat16)
    pc = cost.measure("b1", ops.fused_matmul, x, op)
    dot = 2 * 3 * 96 * 200
    assert pc.flops == pc.dot_flops == pc.kernel_flops == dot
    assert pc.hbm_bytes == pc.kernel_bytes == (cost.nbytes(op.packed) + cost.nbytes(op.scales)
                                               + cost.nbytes(op.codebook) + 3 * 200 * 2
                                               + 3 * 96 * 2)
