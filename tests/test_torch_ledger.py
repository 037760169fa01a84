"""The port's regression ledger (``paper/ledger.py``) and its noise-aware
diff (``paper/bench_diff.py``), as ``tests/test_observatory.py``'s ledger and
bench_diff cases hold the reference's, and against the reference's
committed ledgers:

* a record round-trips through ``append``/``load``; malformed records and
  bad files are refused with the offending key; a record needs a
  framework version, ``torch_version`` (the port's) or ``jax_version`` (the
  reference's);
* the series extractors normalize bench stats into record-valid series;
* ``diff_ledgers`` gates virtual series within their tol, reports wall
  series, and counts a vanished virtual series as a regression;
* the CLI exits 0 on a port CPU candidate (the pinned serve record on the
  CPU) against the reference's ``BENCH_SERVE.json``, 1 on an injected 10 %
  step regression, 1 on a suite mismatch or a missing file, and 0 on the
  self-check of the port's committed ``BENCH_*_TORCH.json``;
* the port's loader reads both reference ledgers;
* ``kernel_series`` of the port's ``kernel_bench`` on the CPU gives
  ``BENCH_KERNELS.json``'s weight bytes and bytes_vs_bf16 exactly.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from repro_torch.paper import bench_diff as bd
from repro_torch.paper import kernel_bench, ledger

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)

_META = dict(git_sha="abc123", torch_version="0.0.test", cuda_version=None, platform="cpu",
             device_kind="cpu", n_devices=1, created_at="2026-01-01T00:00:00+0000", args={})


def _quiet(*_a, **_k):
    pass


def _series(value=10.0, clock="virtual", direction="lower", tol=0.0):
    return {"value": value, "unit": "steps", "clock": clock, "direction": direction,
            "tol": tol}


def test_ledger_record_roundtrip_and_append(tmp_path):
    rec = ledger.make_record({"s.steps": _series()}, meta=_META)
    p = tmp_path / "L.json"
    ledger.append(p, rec, "serve")
    led = ledger.load(p)
    assert led["schema"] == ledger.LEDGER_SCHEMA == "repro-bench-ledger/v1"
    assert led["suite"] == "serve"
    assert led["runs"][0]["series"]["s.steps"]["value"] == 10.0
    ledger.append(p, rec, "serve")
    assert len(ledger.load(p)["runs"]) == 2


@pytest.mark.parametrize("mutate,needle", [
    (lambda r: r.pop("series"), "missing 'series'"),
    (lambda r: r["series"].clear(), "non-empty"),
    (lambda r: r["series"]["s.steps"].pop("clock"), "clock"),
    (lambda r: r["series"]["s.steps"].update(clock="cpu"), "virtual"),
    (lambda r: r["series"]["s.steps"].update(direction="up"), "direction"),
    (lambda r: r["series"]["s.steps"].update(tol=-1), "tol"),
    (lambda r: r["series"]["s.steps"].update(value=float("nan")), "finite"),
    (lambda r: r["meta"].update(git_sha=""), "git_sha"),
    (lambda r: r["meta"].pop("torch_version"), "framework version"),
    (lambda r: r["meta"].update(torch_version="", jax_version=""), "framework version"),
    (lambda r: r["meta"].pop("device_kind"), "device_kind"),
])
def test_ledger_rejects_malformed_records(mutate, needle):
    rec = copy.deepcopy(ledger.make_record({"s.steps": _series()}, meta=_META))
    mutate(rec)
    with pytest.raises(ValueError, match=needle):
        ledger.validate_record(rec)


@pytest.mark.parametrize("framework", ["torch_version", "jax_version"])
def test_ledger_takes_either_framework_version(framework):
    """The deliberate difference from the reference: the port's records
    carry torch_version, the reference's jax_version; either validates."""
    meta = {k: v for k, v in _META.items() if k != "torch_version"}
    meta[framework] = "1.0"
    ledger.validate_record({"meta": meta, "series": {"s.steps": _series()}})


def test_ledger_load_rejects_bad_files(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": "nope", "suite": "serve", "runs": [{}]}))
    with pytest.raises(ValueError, match="schema"):
        ledger.load(p)
    p.write_text(json.dumps({"schema": ledger.LEDGER_SCHEMA, "suite": "what", "runs": [{}]}))
    with pytest.raises(ValueError, match="suite"):
        ledger.load(p)
    p.write_text(json.dumps({"schema": ledger.LEDGER_SCHEMA, "suite": "serve", "runs": []}))
    with pytest.raises(ValueError, match="non-empty"):
        ledger.load(p)
    p.write_text(json.dumps({"schema": ledger.LEDGER_SCHEMA, "suite": "serve",
                             "runs": [{"meta": _META, "series": {"s": {"value": 1}}}]}))
    with pytest.raises(ValueError, match=r"runs\[0\]"):
        ledger.load(p)


@pytest.mark.parametrize("path,suite", [
    (ledger.REFERENCE_SERVE_LEDGER, "serve"),
    (ledger.REFERENCE_KERNEL_LEDGER, "kernels"),
])
def test_port_loader_reads_the_reference_ledgers(path, suite):
    led = ledger.load(path)
    assert led["suite"] == suite and len(led["runs"]) >= 1
    meta = led["runs"][-1]["meta"]
    assert meta["jax_version"] and "torch_version" not in meta
    assert any(s["clock"] == "virtual" for s in led["runs"][-1]["series"].values())


@pytest.mark.parametrize("path,suite", [
    (ledger.SERVE_LEDGER, "serve"),
    (ledger.KERNEL_LEDGER, "kernels"),
])
def test_port_committed_ledgers_validate(path, suite):
    """BENCH_SERVE_TORCH.json / BENCH_KERNELS_TORCH.json: records of the
    port on the card (torch and CUDA versions, the card's name and power
    limit)."""
    led = ledger.load(path)
    assert led["suite"] == suite and len(led["runs"]) >= 1
    meta = led["runs"][-1]["meta"]
    assert meta["torch_version"] and meta["cuda_version"]
    assert meta["platform"] == "cuda" and "H100" in meta["device_kind"]
    assert meta["power_limit"]


def test_series_extractors_normalize_bench_stats():
    sstats = {"kv4_steps": 89, "kv4_mean_latency_steps": 48.3, "kv4_batch_fill": 0.85,
              "kv4_ratio": 3.76, "kv4_logit_gap": 0.51, "tok_s_kv4": 1800.0,
              "kv4_ttft_p99_ms": 120.0, "kv4_itl_p50_ms": 1.6}
    ss = ledger.serve_series(sstats, 4)
    assert ss["serve.kv4_steps"]["clock"] == "virtual"
    assert ss["serve.kv4_steps"]["tol"] == 0.0
    assert ss["serve.kv4_batch_fill"]["tol"] == 1e-6
    assert ss["serve.kv4_logit_gap"]["tol"] == 0.25   # backend-numeric float
    assert ss["serve.tok_s_kv4"]["clock"] == "wall"
    pstats = {"paged_slots_resident": 7, "paged_bytes_ratio": 0.57, "paged_steps": 26,
              "tok_s_paged": 1000.0}
    ps = ledger.paged_series(pstats)
    assert ps["serve.paged_slots_resident"]["direction"] == "higher"
    assert ps["serve.tok_s_paged"]["clock"] == "wall"
    kout = {"fused": {"int4": {"us_dequant_einsum": 100.0, "us_fused": 10.0, "speedup": 10.0,
                               "weight_bytes": 1245184, "bytes_vs_bf16": 0.266}}}
    ks = ledger.kernel_series(kout)
    assert ks["kernel.int4_weight_bytes"]["clock"] == "virtual"
    assert ks["kernel.int4_us_fused"]["clock"] == "wall"
    ledger.make_record({**ss, **ps, **ks}, meta=_META)


def test_kernel_series_of_the_port_kernel_bench_equals_the_reference_bytes(monkeypatch):
    """kernel_bench on the CPU (one call a timing: the bytes do not depend on
    the times) gives BENCH_KERNELS.json's weight bytes and bytes_vs_bf16
    exactly, for each of its four weights."""
    def once(fn, *args, repeats=30):
        fn(*args)
        return 1.0

    monkeypatch.setattr(kernel_bench.common, "timed_robust", once)
    monkeypatch.setattr(kernel_bench.common, "save_json", lambda *a: None)
    _, out = kernel_bench.run(log=_quiet, device="cpu")
    series = ledger.kernel_series(out)
    ref = ledger.load(ledger.REFERENCE_KERNEL_LEDGER)["runs"][-1]["series"]
    virtual = {k for k, s in ref.items() if s["clock"] == "virtual"}
    assert virtual == {k for k, s in series.items() if s["clock"] == "virtual"}
    assert len(virtual) == 8
    for name in virtual:
        assert series[name]["value"] == ref[name]["value"], name
    assert series["kernel.float4_weight_bytes"]["value"] == 2228224
    assert series["kernel.int3_weight_bytes"]["value"] == 1808793
    assert series["kernel.int8_weight_bytes"]["value"] == 4325376


def _one_run_ledger(series, suite="serve"):
    return {"schema": ledger.LEDGER_SCHEMA, "suite": suite,
            "runs": [{"meta": _META, "series": series}]}


def test_bench_diff_gates_virtual_and_reports_wall():
    base = _one_run_ledger({
        "s.steps": _series(100.0),
        "s.tol_steps": _series(100.0, tol=0.05),
        "s.fill": _series(0.8, direction="higher"),
        "s.tok_s": _series(1000.0, clock="wall", direction="higher"),
    })
    d = bd.diff_ledgers(base, copy.deepcopy(base))
    assert d["regressions"] == [] and d["improvements"] == []
    worse = copy.deepcopy(base)
    worse["runs"][0]["series"]["s.steps"]["value"] = 103.0
    worse["runs"][0]["series"]["s.fill"]["value"] = 0.7
    d = bd.diff_ledgers(base, worse)
    assert set(d["regressions"]) == {"s.steps", "s.fill"}
    tol_ok = copy.deepcopy(base)
    tol_ok["runs"][0]["series"]["s.tol_steps"]["value"] = 104.0
    assert bd.diff_ledgers(base, tol_ok)["regressions"] == []
    tol_bad = copy.deepcopy(base)
    tol_bad["runs"][0]["series"]["s.tol_steps"]["value"] = 106.0
    assert bd.diff_ledgers(base, tol_bad)["regressions"] == ["s.tol_steps"]
    fast = copy.deepcopy(base)
    fast["runs"][0]["series"]["s.tok_s"]["value"] = 1.0
    fast["runs"][0]["series"]["s.steps"]["value"] = 90.0
    d = bd.diff_ledgers(base, fast)
    assert d["regressions"] == [] and d["improvements"] == ["s.steps"]
    assert any(line.startswith("wall") and "report-only" in line for line in d["lines"])
    gone = copy.deepcopy(base)
    del gone["runs"][0]["series"]["s.steps"]
    del gone["runs"][0]["series"]["s.tok_s"]
    d = bd.diff_ledgers(base, gone)
    assert d["regressions"] == ["s.steps"]   # a vanished wall series does not gate
    assert set(d["missing"]) == {"s.steps", "s.tok_s"}


def test_bench_diff_wall_baseline_is_the_better_half():
    base = {"schema": ledger.LEDGER_SCHEMA, "suite": "serve",
            "runs": [{"meta": _META, "series": {"s.tok_s": _series(v, clock="wall",
                                                                   direction="higher")}}
                     for v in (100.0, 400.0, 300.0, 200.0)]}
    assert bd._fastest_half([100.0, 400.0, 300.0, 200.0], "higher") == 350.0
    assert bd._fastest_half([100.0, 400.0, 300.0], "lower") == 200.0
    d = bd.diff_ledgers(base, _one_run_ledger({"s.tok_s": _series(350.0, clock="wall",
                                                                   direction="higher")}))
    assert "+0.00%" in d["lines"][0]


@pytest.fixture(scope="module")
def port_candidate(tmp_path_factory):
    """The pinned serve record of the port on the CPU, as a one-run
    candidate ledger."""
    rec = ledger.serve_record(_quiet, device="cpu")
    return ledger.write(tmp_path_factory.mktemp("cand") / "BENCH_SERVE.candidate.json",
                        "serve", [rec])


def test_bench_diff_cli_on_the_reference_baseline(port_candidate, tmp_path, capsys):
    rep = tmp_path / "report.txt"
    assert bd.main(["--baseline", str(ledger.REFERENCE_SERVE_LEDGER),
                    "--new", str(port_candidate), "--report", str(rep)]) == 0
    text = rep.read_text()
    assert "RESULT: ok" in text and "0 regressions" in text
    assert "ok        serve.kv4_steps: 89 -> 89" in text
    capsys.readouterr()

    bad = json.loads(port_candidate.read_text())
    bad["runs"][0]["series"]["serve.kv4_steps"]["value"] *= 1.10
    bad_p = tmp_path / "cand_bad.json"
    bad_p.write_text(json.dumps(bad))
    assert bd.main(["--baseline", str(ledger.REFERENCE_SERVE_LEDGER),
                    "--new", str(bad_p), "--report", str(rep)]) == 1
    text = rep.read_text()
    assert "REGRESSION serve.kv4_steps" in text and "RESULT: REGRESSION" in text
    capsys.readouterr()

    assert bd.main(["--baseline", str(ledger.REFERENCE_KERNEL_LEDGER),
                    "--new", str(port_candidate)]) == 1
    assert bd.main(["--baseline", str(tmp_path / "nope.json"),
                    "--new", str(port_candidate)]) == 1
    assert "suite mismatch" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        bd.main(["--baseline", str(ledger.REFERENCE_SERVE_LEDGER)])


def test_bench_diff_self_check_on_the_port_ledgers(capsys):
    assert bd.main([]) == 0
    out = capsys.readouterr().out
    assert "BENCH_SERVE_TORCH.json" in out and "BENCH_KERNELS_TORCH.json" in out
    assert out.rstrip().endswith("RESULT: ok")


def test_bench_diff_self_check_fails_closed(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ledger, "SERVE_LEDGER", tmp_path / "missing.json")
    monkeypatch.setattr(ledger, "KERNEL_LEDGER", tmp_path / "two_runs.json")
    runs = [{"meta": _META, "series": {"s.steps": _series(v)}} for v in (10.0, 11.0)]
    ledger.write(tmp_path / "two_runs.json", "kernels", runs)
    assert bd.main([]) == 1
    captured = capsys.readouterr()
    assert "no ledger at" in captured.err
    assert "REGRESSION s.steps" in captured.out
