"""The port's serving launcher (``repro_torch.launch.serve``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_launch_serve.py:80-172`` case for case:

* ``validate_flags`` rejects every conflicting pairing with the reference's
  message, and both packages accept and reject the same argv lists;
* the legal flag matrix serves end to end (``--device cpu``), the plan
  riding along;
* the reference's ``--mesh`` cases: ``parse_mesh`` refuses a size that is
  not the world's (the reference: the device count's), naming it, and
  accepts the one that is; the mesh serve smoke runs on a world of one
  (``--mesh 1x1``; a world of two under torchrun is in
  ``tests/test_torch_mesh_serving.py``).  The two tests keep the names they
  had while the port refused the flag (ROADMAP A11);
* ``--profile`` is accepted where the reference accepts it, and serves
  with the roofline summary and the ``profile_*`` families (the two
  ``..._refused_naming_a7`` tests keep the names they had while the port
  refused the flag).

Added: the plan path the launcher's docstring gives — the ``plan`` suite
writes ``plans/tiny-2.6m.json`` and the launcher serves it — and a plan
saved by the reference package served by the port's launcher.
"""

from __future__ import annotations

import dataclasses

import pytest

pytest.importorskip("jax")

from repro.launch import serve as r_serve  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402

CONFLICTS = [
    # --plan owns the weight-quant config
    (("--plan", "p.json", "--bits", "4"), "--plan"),
    (("--plan", "p.json", "--dtype", "float"), "--plan"),
    (("--plan", "p.json", "--block-size", "32"), "--plan"),
    (("--plan", "p.json", "--outlier-pct", "0.5"), "--plan"),
    # --dtype fp16 skips weight quantization
    (("--dtype", "fp16", "--bits", "4"), "fp16"),
    (("--dtype", "fp16", "--block-size", "32"), "fp16"),
    # kv knobs need a quantized cache
    (("--kv-bits", "16", "--kv-block-size", "32"), "--kv-bits"),
    (("--kv-dtype", "int"), "--kv-bits"),
    # mode-mismatched workload flags
    (("--mode", "static", "--num-slots", "4"), "static"),
    (("--mode", "static", "--rate", "1.0"), "static"),
    (("--mode", "static", "--stream"), "static"),
    (("--mode", "continuous", "--batch", "4"), "static-mode"),
    (("--mode", "continuous", "--prompt-len", "16"), "static-mode"),
    # kv probe needs a quantized cache, a telemetry sink, continuous mode
    (("--kv-probe-every", "2", "--metrics-out", "m.prom"), "bf16 cache"),
    (("--kv-bits", "4", "--kv-probe-every", "2"), "telemetry sink"),
    (("--kv-bits", "4", "--kv-probe-every", "0", "--metrics-out", "m.prom"), "positive"),
    (("--mode", "static", "--kv-bits", "4", "--kv-probe-every", "2",
      "--metrics-out", "m.prom"), "continuous-mode"),
    # SLA scheduler flags are continuous-only with validated values
    (("--mode", "static", "--prefill-chunk", "8"), "static"),
    (("--mode", "static", "--priorities", "2"), "static"),
    (("--mode", "static", "--max-preemptions", "1"), "static"),
    (("--prefill-chunk", "0"), "positive chunk length"),
    (("--priorities", "0"), "at least one class"),
    (("--max-preemptions", "-1"), ">= 0"),
    # preemption needs >= 2 classes to ever find a victim
    (("--max-preemptions", "2"), "--priorities"),
    (("--max-preemptions", "2", "--priorities", "1"), "--priorities"),
    # the profiler's gauges need a telemetry sink to land in
    (("--profile",), "--profile"),
    # paged-cache flags: continuous-only, exclusive with chunking/mesh
    (("--mode", "static", "--paged"), "static"),
    (("--page-size", "8"), "--paged"),
    (("--pages", "16"), "--paged"),
    (("--paged", "--prefill-chunk", "8"), "mutually exclusive"),
    (("--paged", "--mesh", "2x4"), "single-host"),
    (("--paged", "--page-size", "0"), "positive"),
    (("--paged", "--pages", "1"), "trash page"),
    # sampling / checkpoint flags validate their values up front
    (("--temperature", "-0.5"), "--temperature"),
    (("--ckpt-dir", "/nonexistent/ckpt-dir-for-test"), "--ckpt-dir"),
]

LEGAL = [
    (),
    ("--kv-bits", "4", "--kv-block-size", "32", "--kv-dtype", "int"),
    ("--plan", "p.json", "--kv-bits", "4", "--matmul-mode", "fused"),
    ("--dtype", "fp16",),
    ("--mode", "static", "--batch", "2", "--prompt-len", "8"),
    ("--mode", "continuous", "--num-slots", "2", "--rate", "1.0"),
    ("--kv-bits", "4", "--kv-probe-every", "2", "--metrics-out", "m.prom",
     "--trace-out", "t.jsonl"),
    ("--mode", "static", "--metrics-out", "m.prom"),
    ("--prefill-chunk", "8"),
    ("--priorities", "2", "--max-preemptions", "2"),
    ("--prefill-chunk", "16", "--priorities", "3", "--max-preemptions", "1",
     "--kv-bits", "4"),
    ("--max-preemptions", "0"),
    ("--paged",),
    ("--paged", "--page-size", "8", "--pages", "32", "--kv-bits", "4"),
    ("--paged", "--priorities", "2", "--max-preemptions", "1"),
]

#: the reference's legal --profile combinations: the port refuses them (A7)
PROFILED = [
    ("--profile", "--metrics-out", "m.prom"),
    ("--profile", "--trace-out", "t.jsonl"),
    ("--mode", "static", "--profile", "--metrics-out", "m.prom"),
]


def _args(mod, *argv):
    return mod.build_argparser().parse_args(["--arch", "tiny-160k", *argv])


@pytest.mark.parametrize("argv,needle", CONFLICTS)
def test_conflicting_flags_rejected(argv, needle):
    """The port rejects each pairing with the reference's message."""
    with pytest.raises(SystemExit, match=needle) as mine:
        serve_mod.validate_flags(_args(serve_mod, *argv))
    with pytest.raises(SystemExit) as ref:
        r_serve.validate_flags(_args(r_serve, *argv))
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("argv", LEGAL)
def test_legal_flag_combinations_validate(argv):
    serve_mod.validate_flags(_args(serve_mod, *argv))
    r_serve.validate_flags(_args(r_serve, *argv))


@pytest.mark.parametrize("argv", PROFILED)
def test_profile_refused_naming_a7(argv):
    """Named when the port refused --profile (A7); since the step profiler
    is ported, both packages accept these argv lists."""
    r_serve.validate_flags(_args(r_serve, *argv))
    serve_mod.validate_flags(_args(serve_mod, *argv))


@pytest.mark.parametrize("device,ok", [("cpu", True), ("cuda", True), ("cuda:1", True),
                                       ("mps", False), ("banana", False)])
def test_device_flag_validated(device, ok):
    """--device, the port's one addition: cuda, cuda:N or cpu."""
    args = _args(serve_mod, "--device", device)
    if ok:
        serve_mod.validate_flags(args)
    else:
        with pytest.raises(SystemExit, match="--device"):
            serve_mod.validate_flags(args)


@pytest.mark.parametrize("spec", ["2x4", "1x1", "banana"])
def test_mesh_refused_naming_a11(spec, monkeypatch):
    """The reference parses DATAxMODEL against its device count (1 here),
    the port against the world's ranks (1 without torchrun): both refuse
    2x4 naming the size, both refuse a malformed spec, both take 1x1 (the
    port's a world of one, gloo on the CPU).  The flags validate either way:
    the world decides."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert serve_mod.parse_mesh(None) is None and r_serve.parse_mesh(None) is None
    serve_mod.validate_flags(_args(serve_mod, "--mesh", spec))
    if spec == "1x1":
        assert r_serve.parse_mesh(spec).shape == {"data": 1, "model": 1}
        mesh = serve_mod.parse_mesh(spec, "cpu")
        try:
            assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        finally:
            dist.destroy_process_group()
        return
    match = "needs 8" if spec == "2x4" else "DATAxMODEL"
    with pytest.raises(SystemExit, match=match):
        r_serve.parse_mesh(spec)
    with pytest.raises(SystemExit, match=match) as e:
        serve_mod.parse_mesh(spec, "cpu")
    assert spec != "2x4" or "the world has 1" in str(e.value)
    assert not dist.is_initialized()


def test_mesh_serve_refused_naming_a11(capsys, monkeypatch):
    """The reference's mesh serve smoke (--kv-bits 4, continuous) on a mesh
    of one rank: the launcher serves every request and leaves no process
    group behind."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    serve_mod.main(["--arch", "tiny-650k", "--mesh", "1x1", "--kv-bits", "4",
                    "--mode", "continuous", "--num-requests", "3", "--num-slots", "2",
                    "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1}" in out and "served 3 requests" in out
    assert "MB/device" in out and not dist.is_initialized()


def test_profile_serve_refused_naming_a7(tmp_path, capsys):
    """Named when the port refused --profile (A7); now the reference's
    test_profile_flag_serves_with_roofline_gauges on the CPU: the serve
    prints the roofline summary and the metrics dump carries the profile_*
    families."""
    mpath = tmp_path / "m.prom"
    serve_mod.main(["--arch", "tiny-160k", "--mode", "continuous", "--kv-bits", "4",
                    "--num-requests", "3", "--num-slots", "2", "--max-new", "4", "--profile",
                    "--metrics-out", str(mpath), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "profiler (" in out and "decode_step" in out, out
    text = mpath.read_text()
    for fam in ("profile_program_flops", "profile_roofline_frac",
                "profile_step_seconds_bucket"):
        assert fam in text, fam
    assert 'kv_bits="4"' in text


# -------------------------------------------------------------------------
# the legal matrix serves end to end on the CPU
# -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_plan(tmp_path_factory):
    """A minimal plan for tiny-160k, saved as --plan JSON."""
    from repro_torch.configs import QuantConfig
    from repro_torch.precision import PrecisionPlan

    plan = PrecisionPlan(arch="tiny-160k",
                         default=dataclasses.asdict(QuantConfig(bits=4, dtype="float",
                                                                block_size=64)),
                         assignments={})
    path = tmp_path_factory.mktemp("plans") / "tiny.json"
    plan.save(path)
    return str(path)


@pytest.mark.parametrize("argv", [
    ("--mode", "static", "--max-new", "4"),
    ("--mode", "static", "--kv-bits", "4", "--matmul-mode", "fused", "--max-new", "4"),
    ("--mode", "continuous", "--kv-bits", "4", "--max-new", "4"),
    ("--mode", "continuous", "--kv-bits", "8", "--kv-block-size", "32",
     "--matmul-mode", "dequant_einsum", "--max-new", "4"),
    ("--mode", "continuous", "--matmul-mode", "fused", "--max-new", "4"),
    ("PLAN", "--mode", "continuous", "--kv-bits", "4", "--max-new", "4"),
    ("PLAN", "--mode", "static", "--matmul-mode", "fused", "--max-new", "4"),
    ("--mode", "continuous", "--kv-bits", "4", "--prefill-chunk", "8",
     "--priorities", "2", "--max-preemptions", "1", "--max-new", "4"),
    ("--mode", "continuous", "--kv-bits", "4", "--paged", "--page-size", "8",
     "--max-new", "4"),
])
def test_flag_matrix_serves(argv, tiny_plan, capsys):
    argv = list(argv)
    if argv and argv[0] == "PLAN":
        argv = ["--plan", tiny_plan] + argv[1:]
    full = ["--arch", "tiny-160k", "--device", "cpu"] + argv
    if argv[argv.index("--mode") + 1] == "continuous":
        full += ["--num-requests", "3", "--num-slots", "2"]
    else:
        full += ["--batch", "2", "--prompt-len", "8"]
    serve_mod.main(full)
    out = capsys.readouterr().out
    assert ("tok/s" in out) or ("generated" in out), out


# -------------------------------------------------------------------------
# the plan path: the plan suite's JSON, and a plan the reference saved
# -------------------------------------------------------------------------

def test_plan_suite_json_serves(tmp_path, monkeypatch, capsys):
    """`paper.run --only plan` writes plans/tiny-2.6m.json; the launcher
    serves it, its metrics holding quant_unit_bits for every unit."""
    from repro_torch.paper import common, run

    monkeypatch.setattr(common, "ART", tmp_path)
    run.main(["--only", "plan", "--device", "cpu"])
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in rows[1:]] == ["plan/h2o-danube-3-4b", "plan/mamba2-130m",
                                                   "plan/tiny-2.6m"]
    path = tmp_path / "plans" / "tiny-2.6m.json"
    m = tmp_path / "m.prom"
    serve_mod.main(["--arch", "tiny-2.6m", "--plan", str(path), "--kv-bits", "4",
                    "--num-requests", "3", "--num-slots", "2", "--max-new", "4",
                    "--metrics-out", str(m), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"quantized per plan {path}" in out and "tok/s" in out
    from repro_torch.precision import PrecisionPlan

    units = PrecisionPlan.load(path).assignments
    text = m.read_text()
    assert all(f'quant_unit_bits{{unit="{u}"}}' in text for u in units)


def test_figmix_gate_and_plan_archs_are_the_reference_s():
    """figmix gates the reference's attention and SSM archs, and the plan
    suite saves their plans and tiny-2.6m's, as benchmarks/fig_mixed_frontier.py."""
    from benchmarks import fig_mixed_frontier as rfig

    from repro_torch.paper import fig_mixed_frontier as tfig

    assert tfig.GATE_ARCHS == rfig.GATE_ARCHS == ["h2o-danube-3-4b", "mamba2-130m"]
    assert tfig.PLAN_ARCHS == rfig.PLAN_ARCHS


def test_reference_plan_serves_in_the_port(tmp_path, capsys):
    """A mixed plan saved by the JAX package (its default config carries
    use_kernel) serves through the port's launcher."""
    import jax

    from repro.configs import QuantConfig as RQuantConfig
    from repro.configs.registry import get_arch as r_get_arch
    from repro.models import lm as rlm
    from repro.models.quantize import quantizable_units as r_units
    from repro.precision import PrecisionPlan as RPrecisionPlan

    cfg = r_get_arch("tiny-160k")
    units = sorted(r_units(rlm.init_params(jax.random.PRNGKey(0), cfg), cfg))
    path = RPrecisionPlan(arch=cfg.name, default=dataclasses.asdict(RQuantConfig()),
                          assignments={u: {"bits": (3, 5, 6, 8, 16)[i % 5]}
                                       for i, u in enumerate(units)}).save(tmp_path / "r.json")
    serve_mod.main(["--arch", "tiny-160k", "--plan", str(path), "--num-requests", "3",
                    "--num-slots", "2", "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    # a partial plan (no covers_all_units) counts the default 4 bits in its mix
    assert "mixed[3,4,5,6,8,16]" in out and "tok/s" in out
