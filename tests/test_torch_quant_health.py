"""The port's quantization-health probes (``record_quant_health``,
``record_tree_bits``, ``kv_roundtrip_error``), ``Engine(telemetry=)`` and
the Server's ``kv_probe_every`` against the JAX package's, on the CPU.

Mirrors ``tests/test_telemetry.py:389-452`` case for case (the load-time
snapshot under a plan, the kv probe leaving tokens unchanged, the
launcher's artifacts) and adds the parity bars: on the reference's
``init_params(PRNGKey(0))`` weights carried across (Qwen2-7B at
``reduced()`` shapes and tiny-650k), every ``quant_unit_bits`` and
``quant_unit_qerr_rms`` gauge within 1e-6 relative of the reference's,
``record_tree_bits`` the same names and bits, ``kv_roundtrip_error`` within
1e-6 on the same rows, and the Server's probe gauges against the
reference Server's on the same prompts (compiled without XLA's excess
precision, as in ``tests/test_torch_serving.py``).  The Engine records its
prefill and decode steps as the reference's does, tokens unchanged.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.core import qtensor as rqtensor  # noqa: E402
from repro.kernels import kv_dequant as rkv  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import quantize as rquant  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.precision import PrecisionPlan as RPrecisionPlan  # noqa: E402
from repro.serving import Server as RServer  # noqa: E402
from repro.serving import Telemetry as RTelemetry  # noqa: E402
from repro.serving import telemetry as rtel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.kernels import kv_dequant as tkv  # noqa: E402
from repro_torch.models.quantize import quantizable_units, quantize_params  # noqa: E402
from repro_torch.precision import PrecisionPlan  # noqa: E402
from repro_torch.serving import NOOP, Engine, Server, StepProfiler, Telemetry  # noqa: E402
from repro_torch.serving.telemetry import (  # noqa: E402
    kv_roundtrip_error,
    record_quant_health,
    record_tree_bits,
)
from repro_torch.serving.trace import validate_events, validate_jsonl  # noqa: E402

torch.set_num_threads(2)

BASE = QuantConfig(bits=4, dtype="float", block_size=64)
R_BASE = RQuantConfig(bits=4, dtype="float", block_size=64)
REL = 1e-6
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture
def no_excess(monkeypatch):
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=NO_EXCESS))


_R_QUANTIZE_UNIT = rquant.quantize_unit


@functools.partial(jax.jit, static_argnums=(0, 2), compiler_options=NO_EXCESS)
def _r_quantize_unit_jit(kind, w, ucfg, outlier_idx):
    return _R_QUANTIZE_UNIT(kind, w, ucfg, outlier_idx=outlier_idx)


@pytest.fixture
def jitted_reference(monkeypatch):
    """The reference's unit quantizer and error (which record_quant_health
    imports at call time) jitted once per shape, without excess precision:
    the same code; eager jax compiles every op and would dominate the
    file's run time."""
    monkeypatch.setattr(rquant, "quantize_unit",
                        lambda kind, w, ucfg, outlier_idx=None:
                        _r_quantize_unit_jit(kind, w, ucfg, outlier_idx))
    monkeypatch.setattr(rqtensor, "quantization_error",
                        jax.jit(rqtensor.quantization_error, compiler_options=NO_EXCESS))


@functools.lru_cache(maxsize=None)
def _weights(name):
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    if not name.startswith("tiny"):
        rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    return rcfg, tcfg, raw, interop.params_from_reference(jax.tree.map(np.asarray, raw),
                                                          device="cpu")


def _gauges(tel, family):
    return {k.split("=", 1)[1]: v["value"]
            for k, v in tel.registry.as_dict().get(family, {}).items()}


def _prompts(vocab, lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, L) for L in lens]


# -------------------------------------------------------------------------
# the load-time snapshot
# -------------------------------------------------------------------------

def test_quant_health_snapshot_with_plan():
    """Per-unit bits and qerr under a plan: a dense unit 16 bits and 0
    error, 8-bit codes above 8 bits, the 4-bit default a bounded error;
    the NOOP recorder records nothing."""
    _, cfg, _, params = _weights("tiny-650k")
    units = sorted(quantizable_units(params, cfg))
    plan = PrecisionPlan(arch=cfg.name, default=dataclasses.asdict(BASE),
                         assignments={units[0]: {"bits": 8}, units[1]: {"bits": 16}})
    tel = Telemetry()
    out = record_quant_health(tel, params, cfg, plan=plan)
    assert set(out) == set(units)
    bits, qerr = _gauges(tel, "quant_unit_bits"), _gauges(tel, "quant_unit_qerr_rms")
    assert bits[units[0]] > 8.0
    assert bits[units[1]] == 16.0 and qerr[units[1]] == 0.0
    assert 0.0 < qerr[units[2]] < 0.5
    assert record_quant_health(NOOP, params, cfg, plan=plan) == {}
    with pytest.raises(ValueError, match="plan= or qcfg="):
        record_quant_health(tel, params, cfg)


@pytest.mark.parametrize("how", ["plan", "qcfg"])
@pytest.mark.parametrize("name", ["qwen2-7b", "tiny-650k"])
def test_quant_health_matches_reference(jitted_reference, name, how):
    """Every unit's gauges within 1e-6 relative of the reference's."""
    rcfg, tcfg, raw, params = _weights(name)
    units = sorted(quantizable_units(params, tcfg))
    assignments = {u: {"bits": (3, 5, 16, 8, 6, 4)[i % 6]} for i, u in enumerate(units)}
    kw, r_kw = {"qcfg": BASE}, {"qcfg": R_BASE}
    if how == "plan":
        kw = {"plan": PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                                    assignments=assignments)}
        r_kw = {"plan": RPrecisionPlan(arch=rcfg.name, default=dataclasses.asdict(R_BASE),
                                       assignments=assignments)}
    tel, r_tel = Telemetry(), RTelemetry()
    mine = record_quant_health(tel, params, tcfg, **kw)
    ref = rtel.record_quant_health(r_tel, raw, rcfg, **r_kw)
    assert list(mine) == list(ref)
    for u, (r_bits, r_err) in ref.items():
        bits, err = mine[u]
        assert bits == r_bits, u
        assert abs(err - r_err) <= REL * r_err, (u, err, r_err)
    assert _gauges(tel, "quant_unit_qerr_rms") == pytest.approx(
        {u: e for u, (_, e) in mine.items()}, rel=0)


@pytest.mark.parametrize("name", ["qwen2-7b", "tiny-650k"])
def test_record_tree_bits_matches_reference(jitted_reference, name):
    rcfg, tcfg, raw, params = _weights(name)
    tel, r_tel = Telemetry(), RTelemetry()
    mine = record_tree_bits(tel, quantize_params(params, BASE, tcfg, device="cpu"))
    ref = rtel.record_tree_bits(r_tel, r_quantize_params(raw, R_BASE, rcfg))
    assert mine == ref and set(mine) == set(quantizable_units(params, tcfg))
    assert record_tree_bits(NOOP, params) == {}


@pytest.mark.parametrize("bits,block", [(4, 64), (8, 64), (4, 32)])
def test_kv_roundtrip_error_matches_reference(bits, block):
    """The same K/V rows, the same spec: within 1e-6 relative."""
    rows = (np.random.RandomState(bits + block).randn(40, 256) * 0.7).astype(np.float32)
    r_spec = rkv.KVQuantSpec(bits=bits, block_size=block, dtype_name="float")
    spec = tkv.KVQuantSpec(bits=bits, block_size=block, dtype_name="float")
    ref = rtel.kv_roundtrip_error(jax.numpy.asarray(rows).astype(jax.numpy.bfloat16), r_spec)
    mine = kv_roundtrip_error(interop.tensor_from_numpy(
        np.asarray(jax.numpy.asarray(rows).astype(jax.numpy.bfloat16)), device="cpu"), spec)
    assert 0 < ref < 1 and abs(mine - ref) <= REL * ref, (mine, ref)


# -------------------------------------------------------------------------
# the Server's kv probe and the Engine's telemetry
# -------------------------------------------------------------------------

def test_kv_probe_measures_error_without_changing_tokens():
    _, cfg, _, params = _weights("tiny-650k")
    cfg4 = cfg.with_kv_quant(4)
    prompts = _prompts(cfg.vocab_size, [6, 9], seed=70)
    tel = Telemetry(kv_probe_every=1)

    def serve(**kw):
        srv = Server(params, cfg4, num_slots=2, max_seq_len=24, device="cpu", **kw)
        ids = [srv.submit(p, 4, arrival_time=0.5 * i) for i, p in enumerate(prompts)]
        res = srv.run_until_drained()
        return [res[i] for i in ids]

    on = serve(telemetry=tel)
    d = tel.registry.as_dict()
    rms = d["kv_append_qerr_rms"][""]["value"]
    assert 0.0 < rms < 1.0
    assert d["kv_append_qerr_max"][""]["value"] >= rms
    assert d["kv_probe_rows_total"][""] >= sum(len(p) for p in prompts)
    assert on == serve()


@pytest.mark.parametrize("paged", [False, True])
def test_kv_probe_matches_reference_server(no_excess, paged):
    """The same prompts through both Servers with kv_probe_every=2: the same
    tokens and probe gauges within 1e-6 relative."""
    rcfg, tcfg, raw, params = _weights("tiny-650k")
    rcfg, tcfg = rcfg.with_kv_quant(4), tcfg.with_kv_quant(4)
    prompts = _prompts(tcfg.vocab_size, [6, 17, 9, 12], seed=71)
    kw = {"paged": True, "page_size": 8} if paged else {}
    tel, r_tel = Telemetry(kv_probe_every=2), RTelemetry(kv_probe_every=2)
    srv = Server(params, tcfg, num_slots=2, max_seq_len=32, telemetry=tel, device="cpu", **kw)
    r_srv = RServer(raw, rcfg, num_slots=2, max_seq_len=32, telemetry=r_tel, **kw)
    ids = [srv.submit(p, 5, arrival_time=1.0 * i) for i, p in enumerate(prompts)]
    r_ids = [r_srv.submit(p, 5, arrival_time=1.0 * i) for i, p in enumerate(prompts)]
    res, r_res = srv.run_until_drained(), r_srv.run_until_drained()
    assert [res[i] for i in ids] == [r_res[i] for i in r_ids]
    d, r_d = tel.registry.as_dict(), r_tel.registry.as_dict()
    assert d["kv_probe_rows_total"][""] == r_d["kv_probe_rows_total"][""]
    for fam in ("kv_append_qerr_rms", "kv_append_qerr_max"):
        m, r = d[fam][""]["value"], r_d[fam][""]["value"]
        assert abs(m - r) <= REL * r, (fam, m, r)


def test_engine_telemetry_records_and_leaves_tokens():
    """Engine(telemetry=): the same tokens as with the no-op; one prefill,
    max_new - 1 decode steps, a trace that validates, the tree's bits."""
    _, cfg, _, params = _weights("tiny-650k")
    qp = quantize_params(params, BASE, cfg, device="cpu")
    prompts = torch.as_tensor(np.stack(_prompts(cfg.vocab_size, [9, 9, 9], seed=50)))
    tel = Telemetry()
    out_tel = Engine(qp, cfg, max_seq_len=16, telemetry=tel, device="cpu").generate(prompts, 6)
    out_off = Engine(qp, cfg, max_seq_len=16, device="cpu").generate(prompts, 6)
    assert torch.equal(out_tel, out_off)
    d = tel.registry.as_dict()
    assert d["serve_decode_steps_total"][""] == 5
    assert d["serve_prefills_total"][""] == 1
    assert d["serve_tokens_total"][""] == 3 * 6
    assert set(_gauges(tel, "quant_unit_bits")) == set(quantizable_units(params, cfg))
    validate_events(tel.tracer.events)


def test_engine_plan_records_health_before_quantizing():
    """Engine(plan=, telemetry=) snapshots the raw tree's health, then
    serves the plan-quantized tree."""
    _, cfg, _, params = _weights("tiny-650k")
    units = sorted(quantizable_units(params, cfg))
    plan = PrecisionPlan(arch=cfg.name, default=dataclasses.asdict(BASE),
                         assignments={u: {"bits": 16 if i == 0 else 5}
                                      for i, u in enumerate(units)})
    tel = Telemetry()
    eng = Engine(params, cfg, max_seq_len=16, plan=plan, telemetry=tel, device="cpu")
    qerr = _gauges(tel, "quant_unit_qerr_rms")
    assert qerr[units[0]] == 0.0 and all(qerr[u] > 0 for u in units[1:])
    assert eng.params is not params


def test_step_profiler_refused_naming_a7():
    """Named when the port refused the step profiler (A7); since it is
    ported, the Engine and the Server take it beside the quant-health
    telemetry and attribute their programs."""
    _, cfg, _, params = _weights("tiny-650k")
    tel = Telemetry(profiler=StepProfiler())
    Engine(params, cfg, max_seq_len=16, telemetry=tel, device="cpu").generate(
        np.arange(1, 9)[None], 3)
    srv = Server(params, cfg, num_slots=2, max_seq_len=16, telemetry=tel, device="cpu")
    srv.submit(np.arange(1, 6), 3)
    srv.run_until_drained()
    names = {r["program"] for r in tel.profiler.summary()}
    assert names == {"prefill[1x8]", "decode_step[1]", "prefill[8]", "decode_step"}, names


def test_launcher_writes_validating_artifacts(tmp_path, capsys):
    """launch/serve.py --metrics-out/--trace-out end to end on the CPU."""
    from repro_torch.launch import serve as serve_mod

    m, t = tmp_path / "metrics.prom", tmp_path / "trace.jsonl"
    serve_mod.main(["--arch", "tiny-160k", "--kv-bits", "4", "--kv-probe-every", "2",
                    "--num-requests", "3", "--num-slots", "2", "--max-new", "4",
                    "--metrics-out", str(m), "--trace-out", str(t), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "telemetry: ttft p50" in out
    assert validate_jsonl(t)["requests"] == 3
    txt = m.read_text()
    assert "# TYPE serve_ttft_seconds histogram" in txt
    assert "kv_append_qerr_rms" in txt
    assert "kv_pool_compression_x" in txt
    assert 'quant_unit_bits{unit="stack/0/mixer/wq"}' in txt
