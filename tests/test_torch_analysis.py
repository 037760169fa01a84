"""reprolint on the port (src/repro_torch/analysis), on the CPU.

* RL003–RL005 against the reference's rules: each of
  ``tests/test_analysis.py``'s corrupt and near-miss fixtures laid out at
  the port's paths gives the same (rule, line, symbol) findings through
  the port's ``run_rules`` as the reference's ``run_rules`` on the copy
  laid out at the reference's paths;
* RL001 (capture purity) and RL002 (branches frozen at capture) on
  fixtures: every forbidden family fires, through a ``self._body`` method
  reference and a ``self.<method>()`` chase; clean bodies stay silent,
  ``engine.py``'s ``if eos is not None`` among them;
* suppressions and the baseline (``LINT_BASELINE_TORCH.json``), the CLI's
  exit codes, and the self-run: the port lints clean;
* the captured-graph auditor's DOT parser on synthetic text and on a real
  graph dumped on an H100 (tiny-160k's fused kv4 Server step,
  ``tests/data/``), its kernel names and routes;
* ``in_place`` over the eager CPU Server (slot and paged, a forced
  preemption): the pool's spill, restore and page wipe write its own
  storage, and a full-pool copy or a rebound buffer is caught; the audit
  refuses the CPU unless asked for it.
"""

from __future__ import annotations

import importlib.util
import io
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import audit
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis import rules
from repro_torch.analysis.findings import Baseline, Finding, apply_suppressions, suppressed_lines
from repro_torch.analysis.rules import run_rules
from repro_torch.configs import QuantConfig, get_arch
from repro_torch.models import lm
from repro_torch.serving import Server

REPO_ROOT = Path(__file__).resolve().parents[1]
REAL_DOT = REPO_ROOT / "tests" / "data" / "tiny160k_kv4_fused_server_step.dot"


def _reference_fixtures():
    """tests/test_analysis.py's fixture dicts (its module, loaded by path)."""
    spec = importlib.util.spec_from_file_location("_reference_analysis_fixtures",
                                                  REPO_ROOT / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mini_repo(tmp_path, files: dict) -> Path:
    root = tmp_path / "mini"
    root.mkdir(parents=True)
    for name, src in files.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def _fired(root: Path) -> set:
    findings, sources = run_rules(root)
    return {f.rule for f in apply_suppressions(findings, sources)}


# -------------------------------------------------------------------------
# RL003–RL005: the reference's findings on the shared fixtures
# -------------------------------------------------------------------------

#: each fixture file at the port's declaration sites (and the reference's:
#: the two packages share the layout under src/<package>/)
LAYOUT = {"tel.py": "serving/telemetry.py", "trace.py": "serving/trace.py",
          "serve.py": "launch/serve.py", "emit.py": "serving/server.py"}
SHARED = [(rule, kind) for rule in ("RL003", "RL004", "RL005") for kind in ("FIRE", "MISS")]


@pytest.mark.parametrize("rule,kind", SHARED, ids=[f"{r}-{k}" for r, k in SHARED])
def test_rl003_to_rl005_match_the_reference(tmp_path, rule, kind):
    from repro.analysis.rules import run_rules as ref_run_rules

    fixture = getattr(_reference_fixtures(), f"{rule}_{kind}")
    port = _mini_repo(tmp_path / "port", {f"src/repro_torch/{LAYOUT[k]}": v
                                          for k, v in fixture.items()})
    ref = _mini_repo(tmp_path / "ref", {f"src/repro/{LAYOUT[k]}": v
                                        for k, v in fixture.items()})
    mine, _ = run_rules(port / "src" / "repro_torch")
    theirs, _ = ref_run_rules(ref / "src" / "repro")
    key = lambda fs: sorted((f.rule, f.line, f.symbol) for f in fs)  # noqa: E731
    assert key(mine) == key(theirs)
    assert any(f.rule == rule for f in mine) == (kind == "FIRE")


# -------------------------------------------------------------------------
# RL001 / RL002 on captured bodies
# -------------------------------------------------------------------------

RL001_FIRE = {
    "steps.py": """
        import time
        from time import perf_counter

        import numpy as np
        import torch

        from repro_torch.serving.engine import capture_graph


        def build(buf, tel, dev):
            def body():
                print(buf)
                t = time.time() + perf_counter()
                n = buf.sum().item()
                host = buf.cpu()
                rows = buf.tolist()
                arr = buf.numpy()
                back = buf.to("cpu")
                torch.cuda.synchronize()
                baked = torch.tensor([1.0, 2.0], device=dev)
                also = torch.as_tensor(rows, device=dev)
                tel.inc("serve_tokens_total")
                tel.observe("serve_itl_seconds", t)
                z = np.zeros(3)
                buf.add_(baked.sum() + also.sum() + n)
            return capture_graph(body, dev)
    """,
}

RL001_METHOD_FIRE = {
    "srv.py": """
        import torch

        from repro_torch.serving.engine import capture_graph


        class Srv:
            def __init__(self, dev):
                self.tok = torch.zeros(4, device=dev)
                self.graph = capture_graph(self._body, dev)

            def _body(self):
                self.tok.copy_(self._work(self.tok))

            def _work(self, tok):
                return tok + self._helper()

            def _helper(self):
                return self.tok.sum().item()
    """,
}

RL001_MISS = {
    "steps.py": """
        import time

        import torch

        from repro_torch.serving.engine import capture_graph


        class Srv:
            def __init__(self, dev):
                self.tok = torch.zeros(4, device=dev)
                self.graph = capture_graph(self._body, dev)

            def _body(self):
                self.tok.add_(1)

            def step(self):
                # host-side around the replay: syncs and clocks are fine
                t0 = time.perf_counter()
                self.graph.replay()
                print(self.tok.cpu().tolist(), time.perf_counter() - t0)
                return self.tok.sum().item()
    """,
}

RL002_FIRE = {
    "steps.py": """
        import torch

        from repro_torch.serving.engine import capture_graph


        class Graph:
            def __init__(self, dev):
                self.done = torch.zeros(4, dtype=torch.bool, device=dev)
                self.pos = torch.zeros((), dtype=torch.int32, device=dev)
                flag = torch.ones((), device=dev)

                def body():
                    if self.done.any():
                        self.pos.add_(1)
                    if flag > 0:
                        self.pos.add_(2)
                    while bool(self.pos):
                        self.pos.sub_(1)
                    if self.pos:
                        self.pos.add_(3)

                self.step = capture_graph(body, dev)
    """,
}

RL002_MISS = {
    "steps.py": """
        import torch

        from repro_torch.serving.engine import capture_graph


        class Graph:
            def __init__(self, cfg, dev, eos=None):
                self.cfg = cfg
                self.tok = torch.zeros(4, dtype=torch.int32, device=dev)
                n_layers = cfg.n_layers

                def body():
                    nxt = self.tok + 1
                    if eos is not None:
                        nxt = torch.where(nxt == eos, self.tok, nxt)
                    if isinstance(nxt, torch.Tensor) and n_layers > 2:
                        nxt = nxt * 2
                    if self.cfg.kv_bits < 16 and self.tok.shape[0] > 1:
                        nxt = nxt + 1
                    self.tok.copy_(nxt)

                self.step = capture_graph(body, dev)
    """,
}

MATRIX = [
    ("RL001", RL001_FIRE, RL001_MISS),
    ("RL001", RL001_METHOD_FIRE, RL001_MISS),
    ("RL002", RL002_FIRE, RL002_MISS),
]
_fix = _reference_fixtures()
MATRIX += [(r, getattr(_fix, f"{r}_FIRE"), getattr(_fix, f"{r}_MISS"))
           for r in ("RL003", "RL004", "RL005")]
IDS = ["RL001", "RL001-method", "RL002", "RL003", "RL004", "RL005"]


@pytest.mark.parametrize("rule,fire,miss", MATRIX, ids=IDS)
def test_rule_fires_on_corrupt_fixture(tmp_path, rule, fire, miss):
    assert rule in _fired(_mini_repo(tmp_path / "f", fire)), \
        f"{rule} must fire on its corrupt fixture"
    assert rule not in _fired(_mini_repo(tmp_path / "m", miss)), \
        f"{rule} must stay silent on its near-miss"


@pytest.mark.parametrize("rule,fire,_", MATRIX, ids=IDS)
def test_cli_exits_1_on_corrupt_fixture(tmp_path, rule, fire, _):
    root = _mini_repo(tmp_path, fire)
    assert lint_mod.lint(root, out=io.StringIO()) == 1


def test_rl001_flags_every_forbidden_family(tmp_path):
    findings, _ = run_rules(_mini_repo(tmp_path, RL001_FIRE))
    msgs = [f.message for f in findings if f.rule == "RL001"]
    for family in ("print()", "wall-clock read 'time.time()'",
                   "wall-clock read 'perf_counter()'", "'.item()'", "'.cpu()'", "'.tolist()'",
                   "'.numpy()'", "'.to(\"cpu\")'", "'torch.cuda.synchronize()'",
                   "'torch.tensor(...)'", "'torch.as_tensor(...)'", "'.inc(...)'",
                   "'.observe(...)'", "host numpy call 'np.zeros()'"):
        assert sum(family in m for m in msgs) == 1, (family, msgs)
    assert {f.symbol for f in findings if f.rule == "RL001"} == {"body"}


def test_rl001_follows_method_references_and_self_calls(tmp_path):
    findings, _ = run_rules(_mini_repo(tmp_path, RL001_METHOD_FIRE))
    [f] = [f for f in findings if f.rule == "RL001"]
    assert f.symbol == "Srv._helper" and "'.item()'" in f.message
    assert "captured body 'Srv._body'" in f.message


def test_rl002_flags_each_tensor_test(tmp_path):
    findings, _ = run_rules(_mini_repo(tmp_path, RL002_FIRE))
    got = [(f.line, f.message.split(" inside")[0]) for f in findings if f.rule == "RL002"]
    assert [m for _, m in got] == [
        "Python 'if' on a tensor's value '.any()'",
        "Python 'if' on the tensor 'flag'",
        "Python 'while' on 'bool()' of a tensor",
        "Python 'if' on the tensor 'self.pos'",
    ]


def test_capture_sites_of_the_port():
    """The Engine's closure and the Server's method body are found, the
    Server's body chased into _decode_program; engine.py's
    ``if eos is not None`` stays clean."""
    ctx = rules.parse_tree(REPO_ROOT / "src" / "repro_torch")
    sites = {(pf.path, s.name): s for pf in ctx.files for s in rules.collect_capture_sites(pf)}
    assert set(sites) == {("serving/engine.py", "body"),
                          ("serving/server.py", "Server._decode_body")}
    assert [n for n, _ in sites["serving/server.py", "Server._decode_body"].chased] == \
        ["Server._decode_program"]
    body = sites["serving/engine.py", "body"]
    assert {"tok", "pos", "done", "out", "col", "temps"} <= body.tensor_attrs
    findings, _ = run_rules(REPO_ROOT / "src" / "repro_torch")
    assert not [f for f in findings if f.rule in ("RL001", "RL002")]


# -------------------------------------------------------------------------
# suppression + baseline semantics
# -------------------------------------------------------------------------

def test_suppression_comment_silences_one_rule(tmp_path):
    files = {"bad.py": """
        from repro_torch.serving.engine import capture_graph


        def build(buf, dev):
            def body():
                print(buf)  # reprolint: disable=RL001
                buf.add_(1)
            return capture_graph(body, dev)
    """}
    assert "RL001" not in _fired(_mini_repo(tmp_path, files))
    assert suppressed_lines("x = 1  # reprolint: disable=RL001, RL003") \
        == {1: {"RL001", "RL003"}}


def test_baseline_grandfathers_with_justification(tmp_path):
    root = _mini_repo(tmp_path, RL002_FIRE)
    bl_path = root / lint_mod.BASELINE_NAME
    entry = {"rule": "RL002", "path": "steps.py", "symbol": "body",
             "why": "intentional: the branches are decided at capture by design"}
    bl_path.write_text(json.dumps({"version": 1, "entries": [entry]}))
    assert lint_mod.lint(root, out=io.StringIO()) == 0

    # an empty justification is itself a lint failure
    entry["why"] = ""
    bl_path.write_text(json.dumps({"version": 1, "entries": [entry]}))
    assert lint_mod.lint(root, out=io.StringIO()) == 1


def test_stale_baseline_entry_fails(tmp_path):
    root = _mini_repo(tmp_path, RL001_MISS)   # a clean tree
    (root / lint_mod.BASELINE_NAME).write_text(json.dumps({
        "version": 1,
        "entries": [{"rule": "RL001", "path": "gone.py", "symbol": "body",
                     "why": "the violation this covered was deleted"}],
    }))
    out = io.StringIO()
    assert lint_mod.lint(root, out=out) == 1
    assert "stale" in out.getvalue()


def test_baseline_partition():
    bl = Baseline(entries=[{"rule": "RL001", "path": "a.py", "symbol": "f", "why": "w"}])
    f_old = Finding("RL001", "a.py", 3, "f", "m")
    f_new = Finding("RL001", "b.py", 9, "g", "m")
    new, old, stale = bl.partition([f_old, f_new])
    assert new == [f_new] and old == [f_old] and stale == []


def test_update_baseline_then_json(tmp_path):
    """--update-baseline writes entries without a why (which fail until
    filled in); --json reports them."""
    root = _mini_repo(tmp_path, RL002_FIRE)
    assert lint_mod.main(["--root", str(root), "--update-baseline"]) == 0
    entries = json.loads((root / lint_mod.BASELINE_NAME).read_text())["entries"]
    assert {e["rule"] for e in entries} == {"RL002"} and all(e["why"] == "" for e in entries)
    out = io.StringIO()
    assert lint_mod.lint(root, out=out, as_json=True) == 1
    data = json.loads(out.getvalue())
    assert not data["new"] and data["grandfathered"] and data["baseline_errors"]


# -------------------------------------------------------------------------
# self-run: the port lints clean against its committed baseline
# -------------------------------------------------------------------------

def test_self_run_zero_nonbaselined_findings():
    out = io.StringIO()
    rc = lint_mod.lint(REPO_ROOT, out=out)
    assert rc == 0, f"the port's lint must be clean:\n{out.getvalue()}"
    assert "0 new" in out.getvalue()


def test_real_violations_are_fixed_not_baselined():
    bl = Baseline.load(REPO_ROOT / lint_mod.BASELINE_NAME)
    assert bl.path.exists()
    for e in bl.entries:
        assert str(e.get("why", "")).strip(), \
            "every committed baseline entry needs a justification"


def test_lint_entry_point_runs_layer1_and_links():
    """scripts/lint_torch.py: Layer 1 against the baseline, then the
    markdown link check, exit 0 on the tree."""
    r = subprocess.run([sys.executable, str(REPO_ROOT / "scripts" / "lint_torch.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "reprolint (port): OK" in r.stdout and "markdown link check" in r.stdout


# -------------------------------------------------------------------------
# Layer 2: the DOT parser (pure text) and a real graph from the card
# -------------------------------------------------------------------------

SYNTHETIC_DOT = r'''digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 3) | _ZN55_GLOBAL__N__f55fd938_22_kv_decode_attention_cu_b9e655f426kv_decode_attention_kernelILi4ELi128ELb0EEEvNS_4ArgsENS_5PagesE\<\<\<8,256,0\>\>\>}
| {cooperative | 0}
}"];
"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 2) | _ZN46_GLOBAL__N__789c2b25_13_qgemv_sm90_cu_dbdd071b15qgemv_tc_kernelILi4ELb1ELi16ELb0EEEvPK13__nv_bfloat16PKjPKtPKfPS1_iiiiiPKix\<\<\<64,128,0\>\>\>}
}"];
"graph_1_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 1) | _ZN46_GLOBAL__N__789c2b25_13_qgemv_sm90_cu_dbdd071b15qgemv_tc_kernelILi4ELb1ELi16ELb1EEEvPK13__nv_bfloat16PKjPKtPKfPS1_iiiiiPKix\<\<\<64,128,0\>\>\>}
}"];
"graph_1_node_3"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {3 (topoId: 0) | 0x0000000009813C70}}
| {kind | HtoD (HOST PINNED to DEVICE)}
}"];
"graph_1_node_4"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {4 (topoId: 4) | 0x00000000098143D8}}
| {kind | DtoD (DEVICE to DEVICE)}
}"];
"graph_1_node_5"[style="solid" shape="record" label="{HOST
| {ID | 5 (topoId: 5)}
}"];
"graph_1_node_6"[style="bold" shape="record" label="{KERNEL
| {ID | 6 (topoId: 6) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_13AUnaryFunctorIfffNS0_15binary_internal10MulFunctorIfEEEESt5arrayIPcLm2EEEEviT0_T1_\<\<\<1,128,0\>\>\>}
}"];
"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
'''


def test_parse_dot_types_kernels_and_host_copies():
    nodes = audit.parse_dot(SYNTHETIC_DOT)
    assert [n.type for n in nodes] == ["KERNEL", "KERNEL", "KERNEL", "MEMCPY", "MEMCPY", "HOST",
                                       "KERNEL"]
    assert [n.touches_host for n in nodes] == [False, False, False, True, False, True, False]
    assert (nodes[3].kind, nodes[3].kind_text) == ("HtoD", "HOST PINNED to DEVICE")
    assert nodes[1].kernel.startswith("_ZN46_GLOBAL__N__") and nodes[1].kernel.endswith("PKix")
    assert audit.kernel_families(nodes) == {
        "kv_decode_attention_kernel": 1, "qgemv_tc_kernel": 2,
        "at::native::vectorized_elementwise_kernel": 1}
    routes = audit.route_counts(nodes)
    assert routes["decode_attention_packed_cuda.launches"] == 1
    # the expert-batched instantiation (EXPERTS = true) counts apart
    assert routes["qmatmul_gemv_tc.launches"] == routes["qmatmul_gemv.launches"] == 1
    assert routes["qmatmul_gemv_experts.launches"] == 1
    assert set(routes) == set(audit.KERNEL_NODES)


@pytest.mark.parametrize("mangled,base", [
    ("_ZN2at6native13reduce_kernelILi512ELi1ENS0_8ReduceOpIfNS0_7MeanOpsIfffiEEjfLi4ELi4EEEEEvT1_",
     "at::native::reduce_kernel"),
    ("_Z12qgemv_kernelIfLi4ELi4ELb1EEvPKT_PKjPKtPKfPS0_iiiii", "qgemv_kernel"),
    ("_ZN7cutlass7Kernel2I42cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16EEvNT_6ParamsE",
     "cutlass::Kernel2"),
    ("_ZNSt6vectorIiE9push_backEv", "std::vector"),
    ("gemmSN_TN_kernel", "gemmSN_TN_kernel"),
    ("kv_dequant", "kv_dequant"),
])
def test_kernel_base_name(mangled, base):
    assert audit.kernel_base_name(mangled) == base


def test_real_dot_from_the_card():
    """tiny-160k's fused 4-bit kv4 slot Server step as an H100 captured it
    (PyTorch 2.11, CUDA 12.8): 14 tensor-core GEMVs (7 matrices a layer, 2
    layers, a tied head), 2 fused attentions, no host node or host copy."""
    nodes = audit.parse_dot(REAL_DOT.read_text())
    assert len(nodes) == 265
    assert not [n for n in nodes if n.touches_host]
    assert {n.type for n in nodes} == {"KERNEL", "MEMCPY"}
    routes = {k: v for k, v in audit.route_counts(nodes).items() if v}
    cfg = get_arch("tiny-160k")
    assert routes == {"qmatmul_gemv.launches": audit.quantized_matrices(cfg),
                      "qmatmul_gemv_tc.launches": audit.quantized_matrices(cfg),
                      "decode_attention_packed_cuda.launches": cfg.n_layers}
    fam = audit.kernel_families(nodes)
    assert sum(fam.values()) == 262 and fam["qgemv_tc_kernel"] == 14


def test_audit_graph_checks_a_dumped_graph(tmp_path):
    """audit_graph on a step whose dump is the real DOT: the graph checks
    pass with the step's recorded launches, and kernel_route fails when the
    record disagrees with the graph."""
    from repro_torch.kernels import launches

    class Step:
        def __init__(self, launched):
            self.launched = launched

        def dump_dot(self, path):
            Path(path).write_text(REAL_DOT.read_text())

    rec = dict.fromkeys(launches.names(), 0)
    rec.update({"qmatmul_gemv.launches": 14, "qmatmul_gemv_tc.launches": 14,
                "decode_attention_packed_cuda.launches": 2})
    report = audit.AuditReport()
    audit.audit_graph(report, "p", Step(tuple(rec.values())), tmp_path / "a.dot",
                      expect={"qmatmul_gemv.launches": 14})
    assert report.ok and [c.check for c in report.checks] == \
        ["no_host_nodes", "kernel_route", "kernel_nodes"]
    rec["decode_attention_packed_cuda.launches"] = 3
    bad = audit.AuditReport()
    audit.audit_graph(bad, "p", Step(tuple(rec.values())), tmp_path / "b.dot")
    assert [c.check for c in bad.failures()] == ["kernel_route"]
    assert "kernel nodes p: 262" in report.render()


def test_dump_dot_needs_a_debug_capture():
    from repro_torch.serving.engine import CapturedStep

    with pytest.raises(RuntimeError, match="debug=True"):
        CapturedStep(None, ()).dump_dot("x.dot")


def test_capture_guard_restores_tensor_methods():
    """The guard (moved from chip_smoke.py) patches Tensor's host-read
    methods and capture_graph while open, and puts both back."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import server as server_mod

    item, capture = torch.Tensor.item, engine_mod.capture_graph
    with audit._capture_guard(torch) as syncs:
        assert torch.Tensor.item is not item
        assert engine_mod.capture_graph is not capture
        assert server_mod.capture_graph is engine_mod.capture_graph
        assert torch.zeros(()).item() == 0.0   # a CPU tensor, outside a capture
    assert syncs == []
    assert torch.Tensor.item is item and engine_mod.capture_graph is capture
    assert server_mod.capture_graph is capture
    assert "__index__" not in torch.Tensor.__dict__ or torch.Tensor.__index__


# -------------------------------------------------------------------------
# Layer 2 on the CPU: in_place over the eager paths, the refusal
# -------------------------------------------------------------------------

def _tiny(kv=4):
    cfg = get_arch("tiny-160k").with_kv_quant(kv)
    return lm.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16), cfg


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_in_place_spill_restore_on_the_cpu_server(kind):
    params, cfg = _tiny()
    report = audit.AuditReport()
    run = audit.audit_server_slot if kind == "slot" else audit.audit_server_paged
    run(report, params, cfg, "kv4", device="cpu")
    assert report.ok, report.render()
    checks = {c.check for c in report.checks}
    want = {"drained", "recapture", "preemption_forced", "in_place", "in_place[spill_slot]",
            "in_place[restore_slot]"}
    assert want <= checks and ("in_place[wipe_pages]" in checks) == (kind == "paged")
    assert not checks & {"no_host_nodes", "kernel_route", "no_host_syncs"}


class _FullCopyRestore(Server):
    """A Server whose pool restores a slot through a copy of every whole
    cache leaf: the silent full-pool copy in_place exists to catch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        real = self.pool.restore_slot

        def restore_slot(slot, spill):
            for group in self.pool.caches:
                for leaf in group.values():
                    leaf.copy_(leaf.clone())
            real(slot, spill)

        self.pool.restore_slot = restore_slot


class _Rebinding(Server):
    """A Server that rebinds its token buffer after the capture: the graph
    would go on reading the old one."""

    def _decode_once(self):
        self._tok = torch.zeros_like(self._tok)
        return super()._decode_once()


@pytest.mark.parametrize("server,failing", [(_FullCopyRestore, "in_place[restore_slot]"),
                                            (_Rebinding, "in_place")])
def test_in_place_catches_a_full_pool_copy_and_a_rebound_buffer(server, failing):
    params, cfg = _tiny()
    report = audit.AuditReport()
    audit.audit_server_slot(report, params, cfg, "kv4", device="cpu", server=server)
    assert [c.check for c in report.failures()] == [failing]


def test_cpu_grid_runs_only_the_eager_checks():
    report = audit.run_audit(kv_bits=(8,), device="cpu")
    assert report.ok, report.render()
    recap = [c for c in report.checks if c.check == "recapture"]
    assert len(recap) == 5 and all("0 captures" in c.detail for c in recap)
    assert any("not run: no graph on the CPU" in n for n in report.notes)
    assert not report.families


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal needs a machine without CUDA")
def test_audit_refuses_the_cpu_unless_asked():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        audit.run_audit(kv_bits=(4,))
    assert audit.main(["--device", "cpu", "--kv-bits", "16"]) == 0


def test_fused_grid_quantizes_the_matrices_on_the_cpu():
    """The fused Server of the grid serves the 4-bit tree on the CPU (its
    expected GEMV nodes are a graph check: not asked for there)."""
    params, cfg = _tiny(16)
    from repro_torch.models.quantize import quantize_params

    q = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                        device="cpu")
    report = audit.AuditReport()
    audit.audit_server_slot(report, q, cfg.with_matmul_mode("fused"), "kv16+fused",
                            device="cpu")
    assert report.ok and audit.quantized_matrices(cfg) == 14
    # a slot's rows: K and V of 2 layers x 32 positions x 64 bf16 features,
    # and the positions, 2 x 32 int32
    pool = Server(params, cfg, num_slots=2, max_seq_len=32, device="cpu").pool
    assert audit.slot_row_bytes(pool) == 2 * (2 * 32 * 64 * 2) + 2 * 32 * 4
