"""The port's mixed-precision planner (``repro_torch.precision``) and plan
path (``quantize_tree(plan=)``, ``quantizable_units``, ``Engine``/``Server``
``plan=``) against the JAX package's, on the CPU.

Mirrors ``tests/test_precision.py`` case for case on the reference's own
h2o-danube-3-4b (a sliding window on every layer) and on Qwen2-7B at
``reduced()`` shapes, and on tiny-650k, with the reference's
``init_params(PRNGKey(0))`` weights carried across through ``interop``.
The bars:

* unit names, shapes, ``n_params`` and proxy outlier index sets equal to
  the reference's;
* plan-quantized packed words and bf16 scales bit for bit (every candidate
  width, a block-size override, a 16-bit unit left dense and equal);
* plan JSON across the two packages both ways (the reference's default
  config carries ``use_kernel``), quantizing to the same tree;
* allocations from the same profiles equal; ``qerr`` within 1e-6 relative
  (the port sums the squares in f64, a stacked unit item by item; the
  reference means them in f32), ``outlier_mass`` within 1e-5,
  ``teacher_forced_kl`` within 1e-4 relative on the same tokens (the
  reference compiled without XLA's excess precision, as in
  ``tests/test_torch_serving.py``);
* ``build_plan`` from the reference's profiles gives the reference's plan,
  by prediction and by measured KL, and from the port's own KL probes too.
  ``teacher_forced_kl`` holds 1e-4 on the mixed trees tested here, not on
  every tree: the dense matmuls (a probe tree is dense but for one unit)
  sum in another order than XLA's dot, a few bf16 outputs in 24,000 differ
  by an ulp, and the KL of a near-dense tree moves by up to ~3e-4
  relative (``python tests/test_torch_precision.py`` prints them, with
  jax installed and ``PYTHONPATH=src``), so those trees are held
  to the plan they give, not to their KL values;
* the Engine's and the Server's greedy tokens under a plan equal to the
  reference's at kv16 and kv4.

The reference's quantized x sharded decode gate becomes the port's: a kv4
Server with a sharder passes ``check_decode_capability`` and serves (a
sharder without a mesh here; the meshes are
``tests/test_torch_mesh_serving.py``); the SSM archs (mamba2-130m, jamba-v0.1-52b at
reduced()) enumerate the reference's units, in_proj and out_proj among
them; an MoE arch (phi3.5-moe at reduced()) runs the plan path and the
load-time health.
Probe tokens are the reference's, passed across as numpy: the two
``probe_tokens`` draw different streams.
"""

import contextlib
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import precision as rprec  # noqa: E402
from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.core import qtensor as rqtensor  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import quantize as rquant  # noqa: E402
from repro.precision import metrics as rmetrics  # noqa: E402
from repro.precision import profile as rprofile  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import Server as RServer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import precision as tprec  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.core.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quantize import (  # noqa: E402
    bits_report,
    quantizable_units,
    quantize_params,
    quantize_tree,
)
from repro_torch.precision import PrecisionPlan  # noqa: E402
from repro_torch.serving import Engine, Server  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(2)

BASE = QuantConfig(bits=4, dtype="float", block_size=64)
R_BASE = RQuantConfig(bits=4, dtype="float", block_size=64)
NAMES = ["h2o-danube-3-4b", "qwen2-7b", "tiny-650k"]
QERR_REL, MASS_ABS, KL_REL = 1e-6, 1e-5, 1e-4
NO_EXCESS = {"xla_allow_excess_precision": False}


_R_QUANTIZE_UNIT = rquant.quantize_unit
_R_JIT = jax.jit


@functools.partial(jax.jit, static_argnums=(0, 2), compiler_options=NO_EXCESS)
def _r_quantize_unit_jit(kind, w, ucfg, outlier_idx):
    return _R_QUANTIZE_UNIT(kind, w, ucfg, outlier_idx=outlier_idx)


def _r_quantize_unit(kind, w, ucfg, outlier_idx=None):
    return _r_quantize_unit_jit(kind, w, ucfg, outlier_idx)


_r_quantization_error = jax.jit(rqtensor.quantization_error, compiler_options=NO_EXCESS)


@contextlib.contextmanager
def _reference_setup():
    """The reference's jax.jit calls compiled without excess precision (its
    KL evaluators afresh), and its unit quantizer and error jitted once per
    shape: the same code, since eager jax compiles every op and would
    dominate the file's run time."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            jax, "jit", functools.partial(_R_JIT, compiler_options=NO_EXCESS)))
        stack.enter_context(mock.patch.object(rmetrics, "_KL_CACHE", {}))
        for mod in (rquant, rprofile):
            stack.enter_context(mock.patch.object(mod, "quantize_unit", _r_quantize_unit))
        stack.enter_context(mock.patch.object(rprofile, "quantization_error",
                                              _r_quantization_error))
        yield


@pytest.fixture
def reference_setup():
    with _reference_setup():
        yield


def _cfgs(name):
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    if not name.startswith("tiny"):
        rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
    return rcfg, tcfg


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(reference cfg, port cfg, reference tree, port tree): the
    reference's PRNGKey(0) init carried across."""
    rcfg, tcfg = _cfgs(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    return rcfg, tcfg, raw, interop.params_from_reference(jax.tree.map(np.asarray, raw),
                                                          device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_profiles(name):
    """The reference's profiles of a model's units: tiny-650k's with the KL
    probes on its probe tokens (returned as numpy), Qwen2-7B's without."""
    rcfg, _, raw, _ = _weights(name)
    probe = name.startswith("tiny")
    toks = rprec.probe_tokens(rcfg, n_seqs=2, seq_len=24) if probe else None
    with _reference_setup():
        profs = rprec.profile_units(raw, rcfg, base=R_BASE, probe_toks=toks)
    return profs, None if toks is None else np.asarray(toks)


def _as_port(profiles) -> dict:
    return {u: tprec.UnitProfile(**dataclasses.asdict(p)) for u, p in profiles.items()}


def _tree_bits(a):
    a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _assert_trees_equal(port_tree, ref_tree):
    carried = interop.flatten(interop.params_from_reference(ref_tree, device="cpu"))
    own = interop.flatten(port_tree)
    assert sorted(carried) == sorted(own)
    bad = [k for k in carried if carried[k].dtype != own[k].dtype
           or not torch.equal(_tree_bits(carried[k]), _tree_bits(own[k]))]
    assert not bad, bad


def _mixed_assignments(units, cycle=(3, 4, 5, 6, 8, 16)):
    out = {u: {"bits": cycle[i % len(cycle)]} for i, u in enumerate(sorted(units))}
    out[sorted(units)[0]] = {"bits": 8, "block_size": 32}
    return out


# -------------------------------------------------------------------------
# unit enumeration agrees with the quantizer, and with the reference
# -------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_units_cover_exactly_the_quantized_leaves(name):
    _, tcfg, _, params = _weights(name)
    units = quantizable_units(params, tcfg, BASE)
    assert all("/" not in u or u.startswith("stack/") for u in units)
    qp = quantize_params(params, BASE, tcfg, device="cpu")
    assert sum(u["n_params"] for u in units.values()) == bits_report(qp)["quantized_params"]


@pytest.mark.parametrize("pct", [0.0, 0.05])
@pytest.mark.parametrize("name", NAMES)
def test_units_match_reference(name, pct):
    """Names, kinds, shapes, n_params and outlier index sets."""
    rcfg, tcfg, raw, params = _weights(name)
    ref = rquant.quantizable_units(raw, rcfg, dataclasses.replace(R_BASE, outlier_pct=pct))
    mine = quantizable_units(params, tcfg, dataclasses.replace(BASE, outlier_pct=pct))
    assert list(mine) == list(ref)
    for u, r in ref.items():
        m = mine[u]
        assert (m["kind"], m["n_params"], m["shape"]) == (r["kind"], r["n_params"], r["shape"])
        if r["outlier_idx"] is None:
            assert m["outlier_idx"] is None
        else:
            assert np.array_equal(m["outlier_idx"].numpy(), np.asarray(r["outlier_idx"]))
    assert (pct > 0) == any(u["outlier_idx"] is not None for u in mine.values())


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_ssm_units_enumerate_as_reference(arch):
    """tests/test_precision.py's SSM case on the port: the SSM mixers'
    in_proj and out_proj are units, and every unit's name, kind, shape and
    n_params is the reference's."""
    rcfg, tcfg = r_get_arch(arch).reduced(), get_arch(arch).reduced()
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(1))
    params = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    ref = rquant.quantizable_units(raw, rcfg, R_BASE)
    mine = quantizable_units(params, tcfg, BASE)
    assert list(mine) == list(ref)
    assert any(u.endswith("mixer/in_proj") for u in mine)
    assert any(u.endswith("mixer/out_proj") for u in mine)
    for u, r in ref.items():
        m = mine[u]
        assert (m["kind"], m["n_params"], m["shape"]) == (r["kind"], r["n_params"], r["shape"])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b"])
def test_moe_plan_quantized_tree_and_health_match_reference(reference_setup, arch):
    """An MoE arch through the plan path: its expert stacks are "moe" units
    (a unit a stack, the router left out), and a plan of every width, a
    block override and a dense unit quantizes the reference's tree bit for
    bit; record_quant_health's per-unit bits and qerr (an expert stack's
    error over its [n_p, E, Out, In] storage) the reference's, qerr within
    1e-5 relative: the reference means the squares in f32 (eagerly, one op
    at a time), the port sums them in f64, and over a stack's 16,384 values
    the f32 mean is 1.3e-6 relative off (the 1e-6 above holds for the
    profile's smaller units)."""
    from repro.serving import telemetry as rtel

    from repro_torch.serving import telemetry as ttel

    rcfg, tcfg = r_get_arch(arch).reduced(), get_arch(arch).reduced()
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    params = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    units = quantizable_units(params, tcfg, BASE)
    assert sorted(u for u, i in units.items() if i["kind"] == "moe") == [
        f"stack/0/ffn/{k}" for k in ("w_down", "w_gate", "w_up")]
    assignments = _mixed_assignments(units)
    r_plan = rprec.PrecisionPlan(arch=rcfg.name, default=dataclasses.asdict(R_BASE),
                                 assignments=assignments)
    plan = PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                         assignments=assignments)
    _assert_trees_equal(quantize_tree(params, tcfg, plan=plan, device="cpu"),
                        rquant.quantize_tree(raw, rcfg, plan=r_plan))
    r_health = rtel.record_quant_health(rtel.Telemetry(), raw, rcfg, plan=r_plan)
    t_health = ttel.record_quant_health(ttel.Telemetry(), params, tcfg, plan=plan)
    assert sorted(r_health) == sorted(t_health)
    for u, (bits, qerr) in r_health.items():
        assert t_health[u][0] == bits, u
        assert abs(t_health[u][1] - qerr) <= 10 * QERR_REL * max(abs(qerr), 1e-12), u


# -------------------------------------------------------------------------
# quantize_tree's plan path
# -------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_plan_quantized_tree_bit_exact_to_reference(reference_setup, name):
    """Every width, a block-size override and a dense unit: packed words
    and bf16 scales bit for bit, the 16-bit unit the raw weight."""
    rcfg, tcfg, raw, params = _weights(name)
    units = quantizable_units(params, tcfg, BASE)
    assignments = _mixed_assignments(units)
    r_plan = rprec.PrecisionPlan(arch=rcfg.name, default=dataclasses.asdict(R_BASE),
                                 assignments=assignments)
    plan = PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                         assignments=assignments)
    mine = quantize_tree(params, tcfg, plan=plan, device="cpu")
    _assert_trees_equal(mine, rquant.quantize_tree(raw, rcfg, plan=r_plan))
    dense = [u for u, a in assignments.items() if a["bits"] >= 16]
    for u in dense:
        *path, last = u.split("/")
        node, src = mine, params
        for k in path:
            node, src = node[int(k) if k.isdigit() else k], src[int(k) if k.isdigit() else k]
        assert node[last]["w"] is src[last]["w"]


def test_plan_overrides_per_unit_bits():
    _, tcfg, _, params = _weights("qwen2-7b")
    units = sorted(quantizable_units(params, tcfg, BASE))
    lo, hi = units[0], units[-1]
    plan = PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                         assignments={lo: {"bits": 3}, hi: {"bits": 8, "block_size": 32}})
    qp = quantize_tree(params, tcfg, plan=plan, device="cpu")
    seen = {k.rsplit(".", 1)[0]: v for k, v in _qtensors(qp).items()}

    def find(unit):
        hits = [v for k, v in seen.items() if all(part in k for part in unit.split("/"))]
        assert hits, (unit, list(seen))
        return hits[0]

    assert find(lo).bits == 3
    qt_hi = find(hi)
    assert qt_hi.bits == 8 and qt_hi.block_size == 32
    assert [v for v in seen.values() if v.bits == 4]


def _qtensors(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_qtensors(tree[k], f"{prefix}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_qtensors(v, f"{prefix}[{i}]"))
    elif isinstance(tree, QuantizedTensor):
        out[prefix + ".qt"] = tree
    return out


def test_plan_bits16_keeps_matrix_dense():
    _, tcfg, _, params = _weights("qwen2-7b")
    units = sorted(quantizable_units(params, tcfg, BASE))
    plan = PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                         assignments={units[0]: {"bits": 16}})
    n_full = len(_qtensors(quantize_params(params, BASE, tcfg, device="cpu")))
    assert len(_qtensors(quantize_tree(params, tcfg, plan=plan, device="cpu"))) == n_full - 1


def test_plan_unknown_unit_rejected():
    _, tcfg, _, params = _weights("qwen2-7b")
    plan = PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                         assignments={"stack/0/mixer/q_typo": {"bits": 8}})
    with pytest.raises(ValueError, match="q_typo"):
        quantize_tree(params, tcfg, plan=plan, device="cpu")


def test_plan_arch_mismatch_rejected():
    _, tcfg, _, params = _weights("qwen2-7b")
    plan = PrecisionPlan(arch="some-other-arch", default=dataclasses.asdict(BASE))
    with pytest.raises(ValueError, match="arch"):
        quantize_tree(params, tcfg, plan=plan, device="cpu")


def test_describe_partial_plan_counts_default_bits():
    partial = PrecisionPlan(arch="x", default=dataclasses.asdict(BASE),
                            assignments={"u": {"bits": 8}})
    assert partial.describe().startswith("mixed[4,8]")
    full = tprec.uniform_plan("x", 8, default=BASE, units=["u", "v"])
    assert full.describe().startswith("uniform k=8")


def test_plan_schema_validation():
    with pytest.raises(ValueError, match="bits"):
        PrecisionPlan(arch="x", assignments={"u": {"dtype": "int"}})
    with pytest.raises(ValueError, match="non-overridable"):
        PrecisionPlan(arch="x", assignments={"u": {"bits": 4, "outlier_pct": 0.1}})
    with pytest.raises(ValueError, match="version"):
        PrecisionPlan(arch="x", version=999)


# -------------------------------------------------------------------------
# JSON round trips, within the port and across the packages
# -------------------------------------------------------------------------

def test_plan_json_roundtrip_bit_exact(tmp_path):
    _, tcfg, _, params = _weights("qwen2-7b")
    plan = tprec.build_plan(params, tcfg, base=BASE, equal_avg_bits=4)
    reloaded = PrecisionPlan.load(plan.save(tmp_path / "plan.json"))
    assert reloaded.assignments == plan.assignments and reloaded.default == plan.default
    qa = interop.flatten(quantize_tree(params, tcfg, plan=plan, device="cpu"))
    qb = interop.flatten(quantize_tree(params, tcfg, plan=reloaded, device="cpu"))
    assert list(qa) == list(qb)
    for k in qa:
        assert qa[k].dtype == qb[k].dtype and torch.equal(_tree_bits(qa[k]), _tree_bits(qb[k])), k


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_plan_json_crosses_packages(reference_setup, tmp_path, direction):
    """A plan saved by either package loads in the other and quantizes the
    same weights to the same tree."""
    rcfg, tcfg, raw, params = _weights("tiny-650k")
    assignments = _mixed_assignments(quantizable_units(params, tcfg, BASE))
    path = tmp_path / "plan.json"
    if direction == "port_to_reference":
        PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                      assignments=assignments, meta={"winner": "x"}).save(path)
        r_plan = rprec.PrecisionPlan.load(path)
        plan = PrecisionPlan.load(path)
    else:
        rprec.PrecisionPlan(arch=rcfg.name, default=dataclasses.asdict(R_BASE),
                            assignments=assignments, meta={"winner": "x"}).save(path)
        plan = PrecisionPlan.load(path)
        r_plan = rprec.PrecisionPlan.load(path)
        assert "use_kernel" in plan.default
    assert plan.assignments == r_plan.assignments == {
        u: dict(a, bits=int(a["bits"])) for u, a in assignments.items()}
    assert plan.default_config() == BASE
    _assert_trees_equal(quantize_tree(params, tcfg, plan=plan, device="cpu"),
                        rquant.quantize_tree(raw, rcfg, plan=r_plan))


# -------------------------------------------------------------------------
# profiles and allocators against the reference's
# -------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_profiles_match_reference(name):
    """qerr at every candidate width within 1e-6 relative, outlier mass
    within 1e-5, the same names, kinds, sizes and shapes."""
    _, tcfg, _, params = _weights(name)
    ref, _ = _ref_profiles(name)
    mine = tprec.profile_units(params, tcfg, base=BASE)
    assert list(mine) == list(ref)
    for u, r in ref.items():
        m = mine[u]
        assert (m.kind, m.n_params, tuple(m.shape)) == (r.kind, r.n_params, tuple(r.shape))
        assert sorted(m.qerr) == sorted(r.qerr)
        for k, e in r.qerr.items():
            assert abs(m.qerr[k] - float(e)) <= QERR_REL * float(e), (u, k, m.qerr[k], e)
        assert abs(m.outlier_mass - r.outlier_mass) <= MASS_ABS, (u, m.outlier_mass)


def test_profiler_measures_outlier_layout():
    """With outlier_pct > 0 the profiled qerr reflects the dense-kept
    outlier columns (lower error than the no-outlier layout)."""
    _, tcfg, _, params = _weights("qwen2-7b")
    base_ol = dataclasses.replace(BASE, outlier_pct=0.05)
    plain = tprec.profile_units(params, tcfg, base=BASE, candidates=(3,))
    ol = tprec.profile_units(params, tcfg, base=base_ol, candidates=(3,))
    better = sum(ol[u].qerr[3] < plain[u].qerr[3] - 1e-4 for u in plain)
    assert better >= len(plain) // 2


def test_probe_bits_outside_candidates():
    """Narrowing ``candidates`` below the probe width still measures qerr at
    probe_bits for calibration."""
    _, tcfg, _, params = _weights("qwen2-7b")
    toks = tprec.probe_tokens(tcfg, n_seqs=1, seq_len=24, device="cpu")
    profs = tprec.profile_units(params, tcfg, base=BASE, candidates=(3,), probe_toks=toks,
                                probe_bits=4)
    assert all(4 in p.qerr and p.probe_coef is not None for p in profs.values())


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("solver", ["greedy_allocate", "lagrangian_allocate"])
def test_allocations_match_reference(name, solver):
    """The same profiles give the same allocation at every anchor, within
    the budget."""
    ref, _ = _ref_profiles(name)
    mine = _as_port(ref)
    for anchor in (3, 4, 5):
        budget = rprec.uniform_cost(ref, anchor, R_BASE)
        assert tprec.uniform_cost(mine, anchor, BASE) == budget
        alloc = getattr(tprec, solver)(mine, budget, base=BASE)
        assert alloc == getattr(rprec, solver)(ref, budget, base=R_BASE)
        assert tprec.allocation_cost(mine, alloc, BASE) <= budget + 1e-6
        assert set(alloc) == set(mine)


def test_more_budget_never_predicts_worse():
    profiles = _as_port(_ref_profiles("qwen2-7b")[0])
    degr = []
    for anchor in (3, 4, 5, 6, 8):
        budget = tprec.uniform_cost(profiles, anchor, BASE)
        alloc = tprec.greedy_allocate(profiles, budget, base=BASE)
        degr.append(tprec.allocation_degradation(profiles, alloc))
    assert all(a >= b - 1e-12 for a, b in zip(degr, degr[1:]))


def test_allocator_beats_uniform_on_predicted():
    profiles = _as_port(_ref_profiles("qwen2-7b")[0])
    budget = tprec.uniform_cost(profiles, 4, BASE)
    alloc = tprec.greedy_allocate(profiles, budget, base=BASE)
    assert (tprec.allocation_degradation(profiles, alloc)
            <= tprec.allocation_degradation(profiles, {u: 4 for u in profiles}) + 1e-12)


def test_infeasible_budget_raises():
    _, tcfg, _, params = _weights("qwen2-7b")
    profiles = _as_port(_ref_profiles("qwen2-7b")[0])
    with pytest.raises(ValueError, match="budget"):
        tprec.build_plan(params, tcfg, base=BASE, profiles=profiles, budget_bits=1.0)


# -------------------------------------------------------------------------
# the KL metric and the planner against the reference's
# -------------------------------------------------------------------------

@pytest.mark.parametrize("cycle", [(3,), (3, 5, 8), (4, 6)])
def test_teacher_forced_kl_matches_reference(reference_setup, cycle):
    """The same mixed-plan trees, the same tokens: KL within 1e-4."""
    rcfg, tcfg, raw, params = _weights("tiny-650k")
    assignments = {u: {"bits": cycle[i % len(cycle)]}
                   for i, u in enumerate(sorted(quantizable_units(params, tcfg, BASE)))}
    toks = np.asarray(rprec.probe_tokens(rcfg, n_seqs=2, seq_len=24))
    r_kl = rprec.teacher_forced_kl(raw, rquant.quantize_tree(raw, rcfg, plan=rprec.PrecisionPlan(
        arch=rcfg.name, default=dataclasses.asdict(R_BASE), assignments=assignments)), rcfg,
        toks)
    kl = tprec.teacher_forced_kl(params, quantize_tree(params, tcfg, plan=PrecisionPlan(
        arch=tcfg.name, default=dataclasses.asdict(BASE), assignments=assignments),
        device="cpu"), tcfg, toks)
    assert r_kl > 0 and abs(kl - r_kl) <= KL_REL * r_kl, (kl, r_kl)


def test_build_plan_from_reference_profiles_by_prediction():
    """No probe: the winner by predicted degradation, and the plan, are the
    reference's."""
    rcfg, tcfg, raw, params = _weights("qwen2-7b")
    ref, _ = _ref_profiles("qwen2-7b")
    for anchor in (3, 4, 5):
        r_plan = rprec.build_plan(raw, rcfg, base=R_BASE, equal_avg_bits=anchor, profiles=ref)
        plan = tprec.build_plan(params, tcfg, base=BASE, equal_avg_bits=anchor,
                                profiles=_as_port(ref))
        assert plan.assignments == r_plan.assignments
        assert plan.meta["winner"] == r_plan.meta["winner"]
        assert plan.meta["predicted"] == pytest.approx(r_plan.meta["predicted"], rel=1e-12)


def test_build_plan_from_reference_profiles_by_measured_kl(reference_setup):
    """With the probe: the same candidates ranked the same way by measured
    KL, the same winner and plan.  (The KLs themselves: see the module
    docstring and ``kl_gaps``.)"""
    rcfg, tcfg, raw, params = _weights("tiny-650k")
    ref, toks = _ref_profiles("tiny-650k")
    r_plan = rprec.build_plan(raw, rcfg, base=R_BASE, equal_avg_bits=4, probe_toks=toks,
                              profiles=ref)
    plan = tprec.build_plan(params, tcfg, base=BASE, equal_avg_bits=4, probe_toks=toks,
                            profiles=_as_port(ref))
    assert plan.assignments == r_plan.assignments
    assert plan.meta["winner"] == r_plan.meta["winner"]
    r_kl, kl = r_plan.meta["measured_kl"], plan.meta["measured_kl"]
    assert sorted(kl, key=kl.get) == sorted(r_kl, key=r_kl.get)


def test_build_plan_from_own_probes_gives_reference_plan(reference_setup):
    """The port's own profiles (its KL probes on the reference's tokens)
    give the plan the reference builds from its own."""
    rcfg, tcfg, raw, params = _weights("tiny-650k")
    ref, toks = _ref_profiles("tiny-650k")
    mine = tprec.profile_units(params, tcfg, base=BASE, probe_toks=torch.tensor(toks))
    assert all(mine[u].probe_coef is not None for u in mine)
    r_plan = rprec.build_plan(raw, rcfg, base=R_BASE, equal_avg_bits=4, profiles=ref)
    plan = tprec.build_plan(params, tcfg, base=BASE, equal_avg_bits=4, profiles=mine)
    assert plan.assignments == r_plan.assignments
    assert plan.meta["winner"] == r_plan.meta["winner"]


def test_planned_mixed_kl_at_most_uniform():
    _, tcfg, _, params = _weights("qwen2-7b")
    toks = tprec.probe_tokens(tcfg, n_seqs=2, seq_len=48, device="cpu")
    plan = tprec.build_plan(params, tcfg, base=BASE, equal_avg_bits=4, probe_toks=toks)
    qp = quantize_tree(params, tcfg, plan=plan, device="cpu")
    qp_uni = quantize_params(params, BASE, tcfg, device="cpu")
    assert (tprec.teacher_forced_kl(params, qp, tcfg, toks)
            <= tprec.teacher_forced_kl(params, qp_uni, tcfg, toks) + 1e-9)
    assert bits_report(qp)["avg_bits_per_param"] <= bits_report(qp_uni)["avg_bits_per_param"] + 1e-9


# -------------------------------------------------------------------------
# serving a plan: the port's Engine and Server against each other and the
# reference's
# -------------------------------------------------------------------------

def _serving_plan(rcfg, tcfg, params):
    units = sorted(quantizable_units(params, tcfg, BASE))
    assignments = {u: {"bits": (3, 5, 8, 16, 6, 4)[i % 6]} for i, u in enumerate(units)}
    return (rprec.PrecisionPlan(arch=rcfg.name, default=dataclasses.asdict(R_BASE),
                                assignments=assignments),
            PrecisionPlan(arch=tcfg.name, default=dataclasses.asdict(BASE),
                          assignments=assignments))


@pytest.mark.parametrize("kv", [16, 4])
def test_engine_and_server_with_plan_match_reference(reference_setup, kv):
    """Engine.generate and the Server's streams under one plan: the port's
    Server equals its Engine, and both equal the reference's."""
    rcfg, tcfg, raw, params = _weights("tiny-650k")
    if kv < 16:
        rcfg, tcfg = rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)
    r_plan, plan = _serving_plan(rcfg, tcfg, params)
    B, S, N = 3, 10, 6
    prompts = np.random.RandomState(5).randint(0, tcfg.vocab_size, (B, S))
    ref = np.asarray(REngine(raw, rcfg, max_seq_len=S + N, plan=r_plan).generate(
        jax.numpy.asarray(prompts), N))
    eng = Engine(params, tcfg, max_seq_len=S + N, plan=plan, device="cpu")
    assert any(isinstance(x, QuantizedTensor) for x in leaves(eng.params))
    out = eng.generate(torch.from_numpy(prompts), N).numpy()
    assert np.array_equal(out, ref)
    r_srv = RServer(raw, rcfg, num_slots=2, max_seq_len=S + N, plan=r_plan)
    srv = Server(params, tcfg, num_slots=2, max_seq_len=S + N, plan=plan, device="cpu")
    r_ids = [r_srv.submit(prompts[b], N, arrival_time=0.3 * b) for b in range(B)]
    ids = [srv.submit(prompts[b], N, arrival_time=0.3 * b) for b in range(B)]
    r_res, res = r_srv.run_until_drained(), srv.run_until_drained()
    for b in range(B):
        assert res[ids[b]] == list(out[b]) == r_res[r_ids[b]], b


def test_server_on_a_mesh_refused_naming_a11():
    """The reference serves quantized x sharded decode through one
    capability gate, and so does the port: a kv4 config passes
    ``check_decode_capability`` on a (duck-typed) 1x2 mesh as in the
    reference, and a kv4 Server with a sharder serves the plain Server's
    tokens.  (The name is the one the test had while the port refused a
    sharder, ROADMAP A11.)"""
    from repro.models.sharding import Sharder as RSharder
    from repro.models.sharding import check_decode_capability as r_check
    from repro_torch.models.sharding import Sharder, check_decode_capability

    class Mesh:
        axis_names = mesh_dim_names = ("data", "model")

        def __init__(self, shape):
            self.shape = shape

    rcfg, tcfg, _, params = _weights("tiny-650k")
    rcfg4, tcfg4 = rcfg.with_kv_quant(4), tcfg.with_kv_quant(4)
    r_check(rcfg4, RSharder(Mesh({"data": 1, "model": 2}), rcfg4, replicate_params_below=0),
            caller="the test")
    check_decode_capability(tcfg4, Sharder(Mesh((1, 2)), tcfg4, replicate_params_below=0),
                            caller="the test")
    prompts = [np.arange(1, 9), np.arange(3, 8)]

    def serve(**kw):
        srv = Server(params, tcfg4, num_slots=2, max_seq_len=16, device="cpu", **kw)
        ids = [srv.submit(p, 5) for p in prompts]
        res = srv.run_until_drained()
        return [res[i] for i in ids]

    assert serve(sharder=Sharder(None, tcfg4)) == serve()


def kl_gaps():
    """teacher_forced_kl of the port and the reference on tiny-650k, the same
    tokens: each one-unit probe tree (the rest dense) and each build_plan
    candidate, and how many bf16 outputs of a dense bf16 dot differ from
    XLA's."""
    rcfg, tcfg, raw, params = _weights("tiny-650k")
    ref, toks = _ref_profiles("tiny-650k")
    dense = dict(dataclasses.asdict(R_BASE), bits=16)
    with _reference_setup():
        for u in ref:
            assign = {u: {"bits": 4}}
            r_tree = rquant.quantize_tree(raw, rcfg, plan=rprec.PrecisionPlan(
                arch=rcfg.name, default=dense, assignments=assign))
            t_tree = quantize_tree(params, tcfg, plan=PrecisionPlan(
                arch=tcfg.name, default={k: v for k, v in dense.items() if k != "use_kernel"},
                assignments=assign), device="cpu")
            r = rprec.teacher_forced_kl(raw, r_tree, rcfg, toks)
            t = tprec.teacher_forced_kl(params, t_tree, tcfg, toks)
            print(f"teacher_forced_kl probe tree {u}: {t:.6e} vs {r:.6e}, "
                  f"relative gap {abs(t / r - 1):.2e}")
        r_plan = rprec.build_plan(raw, rcfg, base=R_BASE, equal_avg_bits=4,
                                     probe_toks=toks, profiles=ref)
    plan = tprec.build_plan(params, tcfg, base=BASE, equal_avg_bits=4, probe_toks=toks,
                               profiles=_as_port(ref))
    for k, r in r_plan.meta["measured_kl"].items():
        t = plan.meta["measured_kl"][k]
        print(f"teacher_forced_kl candidate {k}: {t:.6e} vs {r:.6e}, "
              f"relative gap {abs(t / r - 1):.2e}")
    rs = np.random.RandomState(0)
    for K in (128, 512, 2048):
        x = rs.randn(48, K).astype(np.float32)
        w = (rs.randn(K, 512) * 0.05).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        r = np.asarray(jax.jit(lambda a, b: a @ b.astype(a.dtype),
                                  compiler_options=NO_EXCESS)(xb, jnp.asarray(w)),
                       np.float32)
        xt = interop.tensor_from_numpy(np.asarray(xb), device="cpu").float()
        t = (xt @ torch.from_numpy(w).to(torch.bfloat16).float()).to(torch.bfloat16)
        print(f"dense bf16 dot K={K}: {int((t.float().numpy() != r).sum())} of "
              f"{r.size} outputs differ from XLA's")
    dot_orders()


def dot_orders():
    """ROADMAP C4: XLA's CPU bf16 dot is an f32 sum, a K-block at a time,
    each block summed in K order and the blocks added in order; the block
    depends on the shape (Eigen's blocking from the host's caches).  Prints,
    at tiny-650k's head (K 128, N 2048) and a K of 2048, how many bf16
    outputs a torch f32 matmul and such sums at blocks of 64 and 512 get
    off XLA's."""
    for M, K, N in ((48, 128, 2048), (48, 2048, 512)):
        rs = np.random.RandomState(K + N)
        x = rs.randn(M, K).astype(np.float32)
        w = (rs.randn(K, N) * 0.05).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        r = np.asarray(jax.jit(lambda a, b: a @ b.astype(a.dtype),
                               compiler_options=NO_EXCESS)(xb, jnp.asarray(w)), np.float32)
        xt = interop.tensor_from_numpy(np.asarray(xb), device="cpu").float()
        wt = torch.from_numpy(w).to(torch.bfloat16).float()
        off = {"matmul": int(((xt @ wt).to(torch.bfloat16).float().numpy() != r).sum())}
        for kc in (64, 512):
            acc = torch.zeros((M, N))
            for k0 in range(0, K, kc):
                blk = torch.zeros((M, N))
                for k in range(k0, min(K, k0 + kc)):
                    blk = blk + xt[:, k:k + 1] * wt[k]
                acc = acc + blk
            off[f"blocks of {kc}"] = int((acc.to(torch.bfloat16).float().numpy() != r).sum())
        print(f"dense bf16 dot {M}x{K}x{N}: outputs off XLA's of {r.size}: {off}")


if __name__ == "__main__":
    kl_gaps()
