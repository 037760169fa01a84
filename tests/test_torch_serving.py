"""The port's continuous-batching Server (slot pool, scheduler, chunked
prefill, preemption) against the JAX package's Server and the port's own
Engine, on the CPU.

Weights are the reference's ``init_params(PRNGKey(0))`` carried across with
``interop.params_from_reference`` (4-bit trees quantized by each package
from it); prompts and arrivals are the same numpy arrays for both.  The
reference's jitted steps are compiled without XLA's excess precision
(``jax.jit`` patched for the test), so every bf16 value is rounded where
its code rounds it, as the port does (tests/test_torch_model.py says why);
then the two Servers stream the same greedy tokens.  Each test mirrors one
in ``tests/test_serving.py``:

* the port's Server against the reference's, token for token, at kv16, kv8
  and kv4 with bf16 and 4-bit weights, on tiny-160k and tiny-650k;
* a same-length batch against ``Engine.generate``; mixed lengths against
  per-request generates; staggered arrivals with EOS, slot invariants
  checked at every emitted token;
* chunked prefill token-identical to the plain server at kv16, kv8 and
  kv4, the committed rows bit-identical to a plain prefill's;
* forced preemption token-identical to an unpreempted serve at kv16, kv8
  and kv4, with a trace that passes the lifecycle validator;
* a spilled slot's packed words and scales equal to the reference's spill
  of the same request, and spill -> restore -> spill bit-exact.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving import Server as RServer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.models.sharding import Sharder  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine,
    Server,
    SlotKVCache,
    StepProfiler,
    Telemetry,
)
from repro_torch.serving import server as server_mod  # noqa: E402
from repro_torch.serving import trace  # noqa: E402
from repro_torch.serving.engine import sample_token  # noqa: E402

torch.set_num_threads(2)

NO_EXCESS = {"xla_allow_excess_precision": False}
KVS = [16, 8, 4]


@pytest.fixture
def no_excess(monkeypatch):
    """The reference's jax.jit calls compiled without excess precision."""
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=NO_EXCESS))


@functools.lru_cache(maxsize=None)
def _weights(name, weights):
    """(reference tree, port tree) from the reference's PRNGKey(0) init."""
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    port = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    if weights == "w16":
        return raw, port
    return (r_quantize_params(raw, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg),
            quantize_params(port, QuantConfig(bits=4, dtype="float", block_size=64), tcfg,
                            device="cpu"))


def _cfgs(name, kv):
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    if kv < 16:
        return rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)
    return rcfg, tcfg


def _prompts(lens, seed, vocab=2048):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, L) for L in lens]


def _serve(make, prompts, budgets, *, arrivals=None, priorities=None, **kw):
    srv = make(**kw)
    arrivals = arrivals if arrivals is not None else [1.0 * i for i in range(len(prompts))]
    priorities = priorities if priorities is not None else [0] * len(prompts)
    ids = [srv.submit(p, m, arrival_time=a, priority=pr)
           for p, m, a, pr in zip(prompts, budgets, arrivals, priorities)]
    res = srv.run_until_drained()
    return [res[i] for i in ids], srv


def _port(params, cfg, **kw):
    return functools.partial(Server, params, cfg, device="cpu", **kw)


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("weights", ["w16", "q4"])
@pytest.mark.parametrize("name", ["tiny-160k", "tiny-650k"])
def test_server_matches_reference_server(no_excess, name, weights, kv):
    """Mixed lengths (buckets 8, 16, 32), staggered arrivals, a pool of two:
    rows join and leave mid-flight in both servers alike."""
    rcfg, tcfg = _cfgs(name, kv)
    r_params, t_params = _weights(name, weights)
    lens, budgets = [12, 7, 20, 5, 30, 9], [8, 6, 7, 4, 8, 5]
    prompts = _prompts(lens, seed=5, vocab=tcfg.vocab_size)
    ref, _ = _serve(functools.partial(RServer, r_params, rcfg, num_slots=2, max_seq_len=40),
                    prompts, budgets)
    out, srv = _serve(_port(t_params, tcfg, num_slots=2, max_seq_len=40), prompts, budgets)
    assert out == ref
    assert srv.pool.n_free == 2 and srv.scheduler.drained


def test_same_length_batch_matches_engine():
    _, tcfg = _cfgs("tiny-160k", 16)
    _, params = _weights("tiny-160k", "w16")
    Bn, S, N = 4, 12, 8
    prompts = np.stack(_prompts([S] * Bn, seed=1))
    ref = Engine(params, tcfg, max_seq_len=S + N, device="cpu").generate(prompts, N)
    out, _ = _serve(_port(params, tcfg, num_slots=Bn, max_seq_len=S + N), list(prompts),
                    [N] * Bn, arrivals=[0.0] * Bn)
    assert out == ref.tolist()


@pytest.mark.parametrize("kv", [16, 4])
def test_mixed_lengths_match_per_request_engine(kv):
    _, tcfg = _cfgs("tiny-160k", kv)
    _, params = _weights("tiny-160k", "q4")
    lens, budgets = [12, 7, 10, 5, 9], [8, 4, 6, 3, 5]
    prompts = _prompts(lens, seed=10)
    out, _ = _serve(_port(params, tcfg, num_slots=2, max_seq_len=20), prompts, budgets,
                    arrivals=[1.5 * i for i in range(5)])
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        ref = Engine(params, tcfg, max_seq_len=len(p) + m, device="cpu").generate(p[None], m)
        assert out[i] == ref[0].tolist(), i


def test_slot_invariants_staggered_arrivals_and_eos():
    _, tcfg = _cfgs("tiny-160k", 16)
    _, params = _weights("tiny-160k", "w16")
    n_slots, N = 3, 8
    prompts = _prompts([6, 9, 12, 7, 10, 5, 8], seed=20)
    arrivals = [2.0 * i for i in range(len(prompts))]
    dry, _ = _serve(_port(params, tcfg, num_slots=n_slots, max_seq_len=24), prompts,
                    [N] * len(prompts), arrivals=arrivals)
    eos_id = dry[0][2]
    srv = Server(params, tcfg, num_slots=n_slots, max_seq_len=24, eos_id=eos_id, device="cpu")
    seen = set()

    def check(_rid, _tok):
        assert srv.pool.n_free + srv.pool.n_active == n_slots
        busy = [s for s in range(n_slots) if srv.pool.active[s]]
        assert sorted(srv.scheduler.running) == busy
        seen.update(busy)
        for s in busy:
            assert 0 <= srv.pool.next_pos[s] <= srv.pool.cache_len

    ids = [srv.submit(p, N, arrival_time=a, on_token=check) for p, a in zip(prompts, arrivals)]
    res = srv.run_until_drained()
    assert srv.scheduler.drained and srv.pool.n_free == n_slots and srv.pool.n_active == 0
    assert len(res) == len(prompts) and len(seen) <= n_slots
    eos_hit = 0
    for rid in ids:
        toks = res[rid]
        assert 1 <= len(toks) <= N
        if eos_id in toks:
            assert toks[-1] == eos_id
            eos_hit += len(toks) < N
        else:
            assert len(toks) == N
    assert eos_hit >= 1


_SLA_LENS, _SLA_BUDGETS = [20, 9, 30, 14], [8, 6, 7, 5]


@pytest.mark.parametrize("kv", KVS)
def test_chunked_prefill_token_identical(kv, monkeypatch):
    """Chunks of 8 over buckets of 16 and 32: the same tokens as the plain
    server, and each committed row bit-identical to the plain prefill's."""
    _, tcfg = _cfgs("tiny-160k", kv)
    _, params = _weights("tiny-160k", "q4")
    prompts = _prompts(_SLA_LENS, seed=70)
    rows = {}
    real = server_mod.scatter_row

    def spy(pool, cc, slot, length):
        rows.setdefault(length, []).append([{k: v.clone() for k, v in g.items()} for g in cc])
        return real(pool, cc, slot, length)

    monkeypatch.setattr(server_mod, "scatter_row", spy)
    plain, _ = _serve(_port(params, tcfg, num_slots=2, max_seq_len=40), prompts, _SLA_BUDGETS)
    tel = Telemetry()
    chunked, _ = _serve(_port(params, tcfg, num_slots=2, max_seq_len=40, prefill_chunk=8,
                              telemetry=tel), prompts, _SLA_BUDGETS)
    assert plain == chunked
    assert tel.registry.counter("serve_prefill_chunks_total").value > 0
    assert tel.registry.counter("serve_prefills_total").value == len(prompts)
    for L in (20, 30):
        a, b = rows[L]
        for ga, gb in zip(a, b):
            for key in ga:
                cut = (slice(None), slice(None, L)) if key == "pos" else \
                    (slice(None), slice(None), slice(None, L))
                assert torch.equal(ga[key][cut], gb[key][cut]), (L, key)


@pytest.mark.parametrize("kv", KVS)
def test_preemption_token_identical(kv):
    _, tcfg = _cfgs("tiny-160k", kv)
    _, params = _weights("tiny-160k", "q4")
    lens, budgets = [12, 10, 8, 6, 7], [20, 18, 4, 3, 4]
    prios, arriv = [1, 1, 0, 0, 0], [0.0, 0.0, 3.0, 4.0, 5.0]
    prompts = _prompts(lens, seed=80)
    plain, _ = _serve(_port(params, tcfg, num_slots=2, max_seq_len=40), prompts, budgets,
                      arrivals=arriv)
    tel = Telemetry()
    sla, srv = _serve(_port(params, tcfg, num_slots=2, max_seq_len=40, telemetry=tel,
                            prefill_chunk=8, max_preemptions=2), prompts, budgets,
                      arrivals=arriv, priorities=prios)
    assert srv.scheduler.n_preemptions >= 1
    reg = tel.registry
    assert reg.counter("serve_preemptions_total").value == srv.scheduler.n_preemptions
    assert reg.counter("serve_resumes_total").value == srv.scheduler.n_preemptions
    assert reg.counter("kv_spill_bytes_total", kind="packed").value > 0
    assert plain == sla
    assert trace.validate_events(tel.tracer.events)["requests"] == len(prompts)


def _leaf_bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("kv", KVS)
def test_spill_matches_reference_and_restores_bit_exact(no_excess, kv):
    """Two requests prefilled and decoded five steps in both servers: the
    port's spill of its slot holds the reference's words, scales (or bf16
    rows) and positions bit for bit; restoring it into a scribbled slot and
    spilling again gives the same bits, the neighbour slot untouched."""
    rcfg, tcfg = _cfgs("tiny-160k", kv)
    r_params, t_params = _weights("tiny-160k", "q4")
    prompt = _prompts([11], seed=90)[0]
    servers = [RServer(r_params, rcfg, num_slots=2, max_seq_len=24),
               Server(t_params, tcfg, num_slots=2, max_seq_len=24, device="cpu")]
    for srv in servers:
        srv.submit(prompt, 10)
        srv.submit(prompt[:5], 10)
        for _ in range(5):
            srv.step()
    r_spill = servers[0].pool.spill_slot(0)
    srv = servers[1]
    spill = srv.pool.spill_slot(0)
    keys = sorted(spill["rows"][0])
    assert [np.asarray(r) for r in r_spill["rows"]] and len(r_spill["rows"]) == len(keys)
    for key, r_row in zip(keys, r_spill["rows"]):   # jax flattens dict keys sorted
        ref_bits = _leaf_bits(interop.tensor_from_numpy(np.asarray(r_row), device="cpu"))
        assert np.array_equal(_leaf_bits(spill["rows"][0][key]), ref_bits), key
    assert spill["next_pos"] == r_spill["next_pos"] == 11 + 5
    assert (spill["bytes_packed"], spill["bytes_logical"]) == \
        (r_spill["bytes_packed"], r_spill["bytes_logical"])
    other = {k: v[:, 1].clone() for k, v in srv.pool.caches[0].items()}
    for leaf in srv.pool.caches[0].values():
        leaf[:, 0] = 0
    srv.pool.restore_slot(0, spill)
    again = srv.pool.spill_slot(0)
    for key in keys:
        assert torch.equal(again["rows"][0][key], spill["rows"][0][key]), key
        assert torch.equal(srv.pool.caches[0][key][:, 1], other[key]), key
    ratio = spill["bytes_packed"] / spill["bytes_logical"]
    assert (kv / 16 <= ratio <= kv / 16 * 1.25) if kv < 16 else ratio == 1.0


def test_pool_alloc_free_errors():
    pool = SlotKVCache(get_arch("tiny-160k"), 2, 16, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {0, 1} and pool.n_free == 0
    with pytest.raises(RuntimeError):
        pool.alloc()
    pool.free(a)
    with pytest.raises(AssertionError):
        pool.free(a)
    assert pool.alloc() == a
    vec = pool.pos_vector()
    assert vec is pool.pos_vector() and vec.dtype == torch.int32


def test_server_rejects_unported_options():
    cfg = get_arch("tiny-160k")
    _, params = _weights("tiny-160k", "w16")
    kw = dict(num_slots=1, max_seq_len=16, device="cpu")
    with pytest.raises(ValueError):
        Server(params, cfg, prefill_chunk=0, **kw)
    # a sharder serves (tests/test_torch_mesh_serving.py), with preemption
    # and the step profiler too (tests/test_torch_encdec_mesh.py): both
    # construct
    Server(params, cfg, sharder=Sharder(None, cfg), max_preemptions=1,
           telemetry=Telemetry(profiler=StepProfiler()), **kw)
    # the kv probe and the step profiler are ported: both construct
    Server(params, cfg, telemetry=Telemetry(kv_probe_every=1, profiler=StepProfiler()), **kw)
    srv = Server(params, cfg, **kw)
    with pytest.raises(ValueError):
        srv.submit(np.arange(12), 8)


def test_workloads_serve_to_completion():
    """The port's serving workloads: every request answered within its
    budget, tokens in range; the two-class trace preempts."""
    cfg = get_arch("tiny-160k").with_kv_quant(4)
    _, params = _weights("tiny-160k", "q4")
    for reqs, kw in ((synthetic.serving_workload(cfg.vocab_size, 8, seed=3, device="cpu"), {}),
                     (synthetic.two_class_workload(cfg.vocab_size, 8, seed=4, device="cpu"),
                      {"max_preemptions": 2})):
        srv = Server(params, cfg, num_slots=3, max_seq_len=96, device="cpu", **kw)
        ids = [srv.submit(r["prompt"], r["max_new"], arrival_time=r["arrival_time"],
                          priority=r["priority"]) for r in reqs]
        res = srv.run_until_drained()
        for rid, r in zip(ids, reqs):
            assert 1 <= len(res[rid]) <= r["max_new"]
            assert all(0 <= t < cfg.vocab_size for t in res[rid])
        if kw:
            assert srv.scheduler.n_preemptions >= 1


def test_sample_token_float_and_per_row_temperatures_draw_alike():
    """A float temperature and the same temperature a row (the captured
    steps' form) draw the same tokens from the same generator state; a row
    at temperature 0 is greedy."""
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.randn(4, 300).astype(np.float32)).to(torch.bfloat16)
    for t in (0.3, 0.8, 1.7):
        a = sample_token(logits, torch.Generator().manual_seed(9), t)
        b = sample_token(logits, torch.Generator().manual_seed(9), torch.full((4,), t))
        assert torch.equal(a, b), t
    mixed = sample_token(logits, torch.Generator().manual_seed(9),
                         torch.tensor([0.0, 100.0, 0.0, 100.0]))
    greedy = torch.argmax(logits, -1).to(torch.int32)
    assert torch.equal(mixed[[0, 2]], greedy[[0, 2]])


def test_launch_counters_cover_every_kernel_wrapper():
    """kernels/launches.py moves every counter that a kernel wrapper keeps,
    so a captured step's replays count all of its kernels."""
    import inspect

    from repro_torch.kernels import kv_attention, kv_dequant, launches, qmatmul, quantize

    kept = {(fn.__qualname__, attr) for fn, attr in launches._counters()}
    found = {(fn.__qualname__, attr)
             for mod in (kv_attention, kv_dequant, qmatmul, quantize)
             for _, fn in inspect.getmembers(mod, inspect.isfunction)
             for attr in ("launches", "simt_launches") if hasattr(fn, attr)}
    assert kept == found
    before = launches.snapshot()
    launches.add([1] * len(before))
    assert launches.snapshot() == tuple(n + 1 for n in before)
    launches.add([-1] * len(before))
    assert launches.snapshot() == before
