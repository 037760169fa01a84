"""The port's paged KV pool (``serving/pages.py``, ``attention.write_cache_paged``,
``attention.paged_decode_attention``, ``kv_dequant.gather_pages`` and
``dequant_pages``, ``Server(paged=True)``) against the JAX package, on the
CPU.  Mirrors ``tests/test_paged_pool.py``:

* the port's ``PageAllocator`` under the reference's random-traffic harness
  (seeded and hypothesis-driven), with refcount conservation, no leak and
  fork isolation checked after every operation, and step for step equal to
  the reference's allocator under the same operations;
* ``gather_pages``, ``dequant_pages`` and ``write_cache_paged`` against the
  reference's on the same numpy inputs: identical leaves;
* ``paged_decode_attention`` within 2^-6 of each row's max of the
  reference's at kv16, kv8 and kv4 (two bf16 ulps at the row's max;
  tests/test_torch_encode_attention.py);
* the port's paged Server against the reference's paged Server, token for
  token, at kv16, kv8 and kv4 on tiny-160k with pages of 8 and a
  shared-prefix fork; the reference's jitted steps are compiled without
  XLA's excess precision, as in tests/test_torch_serving.py;
* paged against the slot pool in the port, also under forced preemption,
  with no page left after the drain; the shared-prefix capacity win; page
  gauges and events; flag validation.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.kernels import kv_dequant as rkv  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.serving import Server as RServer  # noqa: E402
from repro.serving import pages as rpages  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import kv_dequant as tkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.serving import Server, StepProfiler, Telemetry, trace  # noqa: E402
from repro_torch.serving.pages import (  # noqa: E402
    PageAllocator,
    PagedKVPool,
    prefix_page_keys,
)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:   # the property test skips; the seeded cases still run
    HAVE_HYPOTHESIS = False

torch.set_num_threads(2)

NO_EXCESS = {"xla_allow_excess_precision": False}
ATT_TOL = 2.0 ** -6          # two bf16 ulps at the row's max
KVS = [16, 8, 4]


@pytest.fixture
def no_excess(monkeypatch):
    """The reference's jax.jit calls compiled without excess precision."""
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=NO_EXCESS))


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# the allocator: the reference's harness, invariants after every operation
# ---------------------------------------------------------------------------

def check_allocator(a) -> None:
    counts: dict[int, int] = {}
    for t in list(a.tables.values()) + list(a.retained.values()):
        for p in t:
            counts[p] = counts.get(p, 0) + 1
    assert counts == a.ref, "refcount conservation violated"
    assert 0 not in a.ref and 0 not in a.free, "trash page handed out"
    held = set(a.ref)
    assert held.isdisjoint(a.free), "page both free and referenced"
    assert len(a.free) + len(held) == a.n_usable, "pages leaked or duplicated"
    assert a.alloc_total - a.freed_total == len(held)
    for k, p in a.prefix_index.items():
        assert a.page_key.get(p) == k, "COW index and reverse map disagree"
        assert p in a.ref, "sealed page with no live reference"


def _state(a) -> tuple:
    return (list(a.free), dict(a.ref), {k: list(v) for k, v in a.tables.items()},
            {k: list(v) for k, v in a.retained.items()}, dict(a.prefix_index),
            a.alloc_total, a.freed_total, a.cow_hits)


def drive(specs, seed, page_size, extra_pages, *, cls=PageAllocator, keys_fn=prefix_page_keys,
          max_ops=300):
    """The reference's random interleaving of admit / seal / preempt /
    resume / release (tests/test_paged_pool.py), the invariants checked
    after every operation.  Returns the allocator's state after each one."""
    need = [cls(2, page_size).pages_needed(len(p), m) for p, m in specs]
    a = cls(max(need) + extra_pages + 1, page_size)
    rng = np.random.default_rng(seed)
    pending = list(range(len(specs)))
    active: dict[int, int] = {}
    preempted: dict[int, int] = {}
    states = []
    for _ in range(max_ops):
        if not (pending or active or preempted):
            break
        choices = (["admit"] if pending else []) + (["preempt", "release"] if active else []) \
            + (["resume"] if preempted else [])
        op = choices[int(rng.integers(len(choices)))]
        if op == "admit":
            i = pending[0]
            prompt, mx = specs[i]
            keys = keys_fn(prompt, page_size, bucket=64)
            n_total = a.pages_needed(len(prompt), mx)
            n_new = n_total - len(a.lookup(keys)[:n_total])
            if not a.can_admit(n_new):
                owner = (int(rng.choice(list(active))) if active
                         else int(rng.choice(list(preempted))))
                a.release(owner)
                active.pop(owner, None)
                preempted.pop(owner, None)
                check_allocator(a)
                states.append(_state(a))
                continue
            pending.pop(0)
            table, n_shared = a.admit(i, keys, n_total)
            assert len(table) == n_total
            for p in table[n_shared:]:
                # fork isolation: fresh pages are ours alone
                assert a.ref[p] == 1 and p not in a.page_key
            a.seal(i, keys)
            active[i] = i
        elif op == "preempt":
            owner = int(rng.choice(list(active)))
            _, private = a.private_suffix(owner)
            freed = a.detach_private(owner)
            assert set(freed) <= set(private), "preempt freed a sealed prefix page"
            del active[owner]
            preempted[owner] = len(private)
        elif op == "resume":
            owner = int(rng.choice(list(preempted)))
            n_private = preempted[owner]
            if a.can_admit(n_private):
                table = a.resume(owner, n_private)
                for p in table[len(table) - n_private:]:
                    assert a.ref[p] == 1
                del preempted[owner]
                active[owner] = owner
            else:
                a.release(owner)
                del preempted[owner]
        else:
            owner = int(rng.choice(list(active)))
            a.release(owner)
            del active[owner]
        check_allocator(a)
        states.append(_state(a))
    for owner in list(active) + list(preempted):
        a.release(owner)
        check_allocator(a)
    assert not a.ref and not a.prefix_index and not a.page_key
    assert a.n_free == a.n_usable, "a drained pool must be whole again"
    return states


def _specs(seed):
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(0, 3, rng.integers(1, 20))),
             int(rng.integers(1, 6))) for _ in range(10)]


@pytest.mark.parametrize("seed", range(6))
def test_seeded_page_traffic_matches_reference_allocator(seed):
    """The reference's seeded traffic: every invariant after every
    operation, and the port's allocator in the reference's state after each
    (free list, refcounts, tables, retained prefixes, COW index, counts)."""
    specs = _specs(seed)
    extra = int(np.random.default_rng(seed).integers(0, 8))
    mine = drive(specs, seed + 100, 4, extra)
    ref = drive(specs, seed + 100, 4, extra, cls=rpages.PageAllocator,
                keys_fn=rpages.prefix_page_keys)
    assert mine == ref


if HAVE_HYPOTHESIS:
    prompt_st = st.lists(st.integers(0, 2), min_size=1, max_size=24)

    @settings(max_examples=150, deadline=None, derandomize=True)
    @given(specs=st.lists(st.tuples(prompt_st.map(tuple), st.integers(1, 6)), min_size=1,
                          max_size=12),
           seed=st.integers(0, 2**31 - 1), page_size=st.sampled_from([2, 4, 8]),
           extra_pages=st.integers(0, 10))
    def test_random_traffic_upholds_page_invariants(specs, seed, page_size, extra_pages):
        drive(specs, seed, page_size, extra_pages)


def test_allocator_validation_and_capacity():
    with pytest.raises(ValueError):
        PageAllocator(1, 4)
    with pytest.raises(ValueError):
        PageAllocator(8, 0)
    a = PageAllocator(5, 4)
    assert a.n_usable == 4 and a.n_free == 4
    assert a.pages_needed(5, 4) == 2 and a.pages_needed(4, 1) == 1
    table, n_shared = a.admit("A", [], 4)
    assert n_shared == 0 and a.n_free == 0
    with pytest.raises(RuntimeError):
        a.admit("B", [], 1)
    with pytest.raises(AssertionError):
        a.admit("A", [], 1)
    assert sorted(a.release("A")) == sorted(table) and a.n_free == 4


def test_cow_fork_shares_sealed_prefix_only():
    ps = 4
    a = PageAllocator(16, ps)
    k1 = prefix_page_keys(tuple(range(10)), ps, bucket=16)
    t1, s1 = a.admit("A", k1, a.pages_needed(10, 4))
    a.seal("A", k1)
    k2 = prefix_page_keys(tuple(range(8)) + (9, 9), ps, bucket=16)
    t2, s2 = a.admit("B", k2, a.pages_needed(10, 4))
    assert s1 == 0 and s2 == 2 and t2[:2] == t1[:2]
    assert not set(t2[2:]) & set(t1), "private suffixes must not alias"
    assert a.ref[t1[0]] == 2 and a.n_shared == 2 and a.cow_hits == 2
    # another bucket does not fork (identical bytes only within one bucket)
    _, s3 = a.admit("C", prefix_page_keys(tuple(range(8)) + (9, 9), ps, bucket=32), 4)
    assert s3 == 0
    for o in ("A", "B", "C"):
        a.release(o)
    check_allocator(a)
    assert a.n_free == a.n_usable and not a.prefix_index


def test_preempt_retains_prefix_resume_is_fresh():
    ps = 4
    a = PageAllocator(16, ps)
    keys = prefix_page_keys(tuple(range(8)), ps, bucket=8)
    table, _ = a.admit("A", keys, a.pages_needed(8, 6))
    a.seal("A", keys)
    prefix, private = a.private_suffix("A")
    assert prefix == table[:2] and private == table[2:]
    assert a.detach_private("A") == private
    assert a.retained["A"] == prefix and len(a.lookup(keys)) == 2
    new = a.resume("A", len(private))
    assert new[:2] == prefix and all(a.ref[p] == 1 for p in new[2:])
    a.release("A")
    check_allocator(a)
    assert not a.prefix_index


# ---------------------------------------------------------------------------
# the device half against the reference's functions
# ---------------------------------------------------------------------------

def _paged_case(bits, n_pages, ps, B, P, seed, K=2, Dh=32):
    """Page-major leaves (the reference's encode at kv4/kv8), each page's
    positions a run with holes, and a page map with shuffled ids, shared
    pages and unallocated (trash) entries, as numpy."""
    rs = np.random.RandomState(seed)
    feat = K * Dh
    k = rs.randn(n_pages, ps, feat).astype(np.float32)
    v = rs.randn(n_pages, ps, feat).astype(np.float32)
    if bits < 16:
        spec = rkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
        kp, ks = rkv.encode_rows(jnp.asarray(k, jnp.bfloat16), spec)
        vp, vs = rkv.encode_rows(jnp.asarray(v, jnp.bfloat16), spec)
        leaves = {"k_packed": np.asarray(kp), "k_scales": np.asarray(ks),
                  "v_packed": np.asarray(vp), "v_scales": np.asarray(vs)}
    else:
        leaves = {"k": np.asarray(jnp.asarray(k.reshape(n_pages, ps, K, Dh), jnp.bfloat16)),
                  "v": np.asarray(jnp.asarray(v.reshape(n_pages, ps, K, Dh), jnp.bfloat16))}
    pos = (np.arange(n_pages * ps) % (P * ps)).reshape(n_pages, ps).astype(np.int32)
    pos[rs.rand(n_pages, ps) < 0.15] = -1
    pos[0] = -1                                      # the trash page
    leaves["pos"] = pos
    page_map = rs.permutation(np.arange(1, n_pages))[: B * P].reshape(B, P).astype(np.int32)
    page_map[1, 0] = page_map[0, 0]                  # a shared page
    page_map[-1, -1] = 0                             # an unallocated entry
    return leaves, page_map


@pytest.mark.parametrize("bits", KVS)
def test_gather_and_dequant_pages_match_reference(bits):
    leaves, page_map = _paged_case(bits, 12, 8, 3, 3, seed=bits)
    for key, leaf in leaves.items():
        ref = np.asarray(rkv.gather_pages(jnp.asarray(leaf), jnp.asarray(page_map)))
        out = tkv.gather_pages(_t(leaf), torch.from_numpy(page_map))
        assert tuple(out.shape) == ref.shape and np.array_equal(_bits(out), _bits(_t(ref))), key
    if bits < 16:
        feat = 64
        r_spec = rkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
        ref = rkv.dequant_pages(jnp.asarray(leaves["k_packed"]), jnp.asarray(leaves["k_scales"]),
                                jnp.asarray(page_map), r_spec, feat)
        out = tkv.dequant_pages(_t(leaves["k_packed"]), _t(leaves["k_scales"]),
                                torch.from_numpy(page_map),
                                tkv.KVQuantSpec(bits=bits, block_size=64), feat)
        assert np.array_equal(_bits(out), _bits(_t(np.asarray(ref))))


@pytest.mark.parametrize("bits", KVS)
def test_write_cache_paged_matches_reference(bits):
    """One decode token a row through the page map, an idle row (the trash
    page, pos -1) among them: every leaf the reference's, bit for bit."""
    n_pages, ps, B, P, K, Dh = 12, 8, 3, 3, 2, 32
    leaves, page_map = _paged_case(bits, n_pages, ps, B, P, seed=10 + bits)
    # every live write lands on an allocated page: the trash entry gets an
    # unused one
    page_map[-1, -1] = min(set(range(1, n_pages)) - set(page_map.ravel().tolist()))
    rs = np.random.RandomState(bits)
    k_new = np.asarray(jnp.asarray(rs.randn(B, K, Dh), jnp.bfloat16))
    v_new = np.asarray(jnp.asarray(rs.randn(B, K, Dh), jnp.bfloat16))
    pos = np.array([5, -1, 17], np.int32)
    r_spec = (rkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float") if bits < 16
              else None)
    t_spec = tkv.KVQuantSpec(bits=bits, block_size=64) if bits < 16 else None
    ref = rattn.write_cache_paged({k: jnp.asarray(v) for k, v in leaves.items()},
                                  jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos),
                                  jnp.asarray(page_map), page_size=ps, kvq=r_spec)
    cache = {k: _t(v) for k, v in leaves.items()}
    tattn.write_cache_paged(cache, _t(k_new), _t(v_new), torch.from_numpy(pos),
                            torch.from_numpy(page_map), page_size=ps, kvq=t_spec)
    for key in leaves:
        assert np.array_equal(_bits(cache[key]), _bits(_t(np.asarray(ref[key])))), key
    assert cache["pos"][page_map[0, 0], 5] == 5 and cache["pos"][page_map[2, 2], 1] == 17
    assert not bool((cache["pos"][0] >= 0).any()), "the trash page holds a position"


@pytest.mark.parametrize("bits", KVS)
def test_paged_decode_attention_matches_reference(bits):
    """A position a row (one idle), pages shared between rows and a trash
    entry: within 2^-6 of each row's max of the reference's read; the idle
    row exactly 0."""
    n_pages, ps, B, P, K, G, Dh = 12, 8, 3, 3, 2, 7, 32
    leaves, page_map = _paged_case(bits, n_pages, ps, B, P, seed=20 + bits)
    rs = np.random.RandomState(bits + 1)
    q = np.asarray(jnp.asarray(rs.randn(B, K * G, Dh) * 2, jnp.bfloat16))
    pos = np.array([20, 13, -1], np.int32)
    r_spec = (rkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float") if bits < 16
              else None)
    t_spec = tkv.KVQuantSpec(bits=bits, block_size=64) if bits < 16 else None
    ref = np.asarray(jax.jit(lambda q, c, p, m: rattn.paged_decode_attention(
        q, c, p, m, kvq=r_spec))(jnp.asarray(q), {k: jnp.asarray(v) for k, v in leaves.items()},
                                 jnp.asarray(pos), jnp.asarray(page_map)).astype(jnp.float32))
    out = tattn.paged_decode_attention(_t(q), {k: _t(v) for k, v in leaves.items()},
                                       torch.from_numpy(pos), torch.from_numpy(page_map),
                                       kvq=t_spec)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, K * G, Dh)
    gap = np.abs(out.float().numpy() - ref).max(-1)
    assert (gap <= ATT_TOL * np.abs(ref).max(-1)).all(), gap.max()
    assert not bool(out[2].abs().any()) and ref[:2].any()


# ---------------------------------------------------------------------------
# the paged Server
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weights(name):
    """(reference tree, port tree) from the reference's PRNGKey(0) init,
    4-bit float at block 64, each package quantizing its own."""
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    port = interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    return (r_quantize_params(raw, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg),
            quantize_params(port, QuantConfig(bits=4, dtype="float", block_size=64), tcfg,
                            device="cpu"))


def _cfgs(kv):
    rcfg, tcfg = r_get_arch("tiny-160k"), get_arch("tiny-160k")
    return (rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)) if kv < 16 else (rcfg, tcfg)


def _fork_prompts(vocab, seed=1):
    """The reference's mixed lengths and a fork of the 23-token prompt's
    first two pages of 8."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, n).tolist() for n in (5, 11, 23, 7)]
    prompts.append(prompts[2][:16] + [3, 4, 5])
    return prompts


def _serve(make, prompts, *, max_new=6, priorities=None, arrivals=None, **kw):
    srv = make(**kw)
    for i, pr in enumerate(prompts):
        srv.submit(pr, max_new=max_new,
                   arrival_time=float(i) if arrivals is None else arrivals[i],
                   priority=0 if priorities is None else priorities[i])
    return srv, srv.run_until_drained()


def _port(params, cfg, **kw):
    return functools.partial(Server, params, cfg, max_seq_len=64, device="cpu", **kw)


def _leak_free(srv):
    a = srv.pool.allocator
    return a.n_free == a.n_usable and not a.ref and not a.retained and not a.prefix_index


@pytest.mark.parametrize("kv", KVS)
def test_paged_server_matches_reference_paged_server(no_excess, kv):
    """Pages of 8, three rows, a shared-prefix fork: the reference's paged
    Server's greedy tokens, and the port's slot pool's; no page left."""
    rcfg, tcfg = _cfgs(kv)
    r_params, t_params = _weights("tiny-160k")
    prompts = _fork_prompts(tcfg.vocab_size)
    _, ref = _serve(functools.partial(RServer, r_params, rcfg, num_slots=3, max_seq_len=64,
                                      paged=True, page_size=8), prompts)
    srv, out = _serve(_port(t_params, tcfg, num_slots=3, paged=True, page_size=8), prompts)
    assert out == ref
    assert srv.pool.allocator.cow_hits >= 2
    assert _leak_free(srv)
    _, slot = _serve(_port(t_params, tcfg, num_slots=3), prompts)
    assert out == slot


@pytest.mark.parametrize("kv", KVS)
def test_paged_preemption_token_identical(kv):
    """Two classes on two rows force a spill of private pages and a restore
    onto fresh ones: the tokens of an unpressured paged run and of the slot
    pool under the same preemption; every page back after the drain."""
    _, tcfg = _cfgs(kv)
    _, params = _weights("tiny-160k")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, tcfg.vocab_size, 12).tolist() for _ in range(3)]
    kw = dict(max_new=10, priorities=[1, 1, 0])
    srv, out = _serve(_port(params, tcfg, num_slots=2, paged=True, page_size=8,
                            max_preemptions=2), prompts, **kw)
    assert srv.scheduler.n_preemptions > 0, "the scenario must preempt"
    _, calm = _serve(_port(params, tcfg, num_slots=3, paged=True, page_size=8), prompts,
                     max_new=10)
    _, slot = _serve(_port(params, tcfg, num_slots=2, max_preemptions=2), prompts, **kw)
    assert out == calm == slot
    assert _leak_free(srv)


def test_spill_restore_moves_private_pages_bit_exact():
    """A spill copies the private pages as stored and frees them (positions
    wiped to -1); the restore writes them onto fresh pages, whose contents
    then equal the spill bit for bit; the sealed prefix stays resident."""
    _, tcfg = _cfgs(4)
    _, params = _weights("tiny-160k")
    srv = Server(params, tcfg, num_slots=2, max_seq_len=64, paged=True, page_size=8,
                 device="cpu")
    srv.submit(list(range(1, 20)), 12)
    for _ in range(4):
        srv.step()
    pool = srv.pool
    owner = pool._slot_meta[0]["owner"]
    prefix, private = pool.allocator.private_suffix(owner)
    assert len(prefix) == 2 and private
    spill = pool.spill_slot(0)
    assert spill["n_private"] == len(private) and spill["n_retained"] == 2
    assert all(not bool((pool.caches[0]["pos"][:, p] >= 0).any()) for p in private)
    assert pool.allocator.retained[owner] == prefix
    pool.restore_slot(0, spill)
    for mine, theirs in zip(pool.private_rows(0), spill["rows"]):
        for key in mine:
            assert np.array_equal(_bits(mine[key]), _bits(theirs[key])), key
    ratio = spill["bytes_packed"] / spill["bytes_logical"]
    assert 4 / 16 <= ratio <= 4 / 16 * 1.25


def test_shared_prefix_capacity_win():
    """With a page budget below what four unshared residents need, four
    requests with one 24-token prefix are resident at once, the prefix
    stored once; their tokens are the slot pool's."""
    _, tcfg = _cfgs(4)
    _, params = _weights("tiny-160k")
    rng = np.random.default_rng(3)
    base = rng.integers(1, tcfg.vocab_size, 24).tolist()
    prompts = [base + rng.integers(1, tcfg.vocab_size, 2).tolist() for _ in range(4)]
    # each needs ceil((26 + 8 - 1) / 8) = 5 pages; four unshared would need
    # 20; 12 hold one 3-page prefix and four 2-page suffixes
    srv = Server(params, tcfg, num_slots=4, max_seq_len=64, paged=True, page_size=8,
                 n_pages=13, device="cpu")
    for pr in prompts:
        srv.submit(pr, max_new=8, arrival_time=0.0)
    peak = 0
    while not srv.scheduler.drained:
        srv.step()
        peak = max(peak, len(srv.scheduler.running))
    assert peak == 4, f"COW should hold all 4 residents, peak {peak}"
    assert srv.pool.allocator.cow_hits >= 9
    res = {r.id: list(r.tokens) for r in srv.scheduler.finished}
    _, ref = _serve(_port(params, tcfg, num_slots=4), prompts, max_new=8,
                    arrivals=[0.0] * 4)
    assert res == ref
    assert _leak_free(srv)


def test_paged_trace_and_gauges():
    _, tcfg = _cfgs(4)
    _, params = _weights("tiny-160k")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tcfg.vocab_size, 12).tolist() for _ in range(3)]
    tel = Telemetry()
    srv, _ = _serve(_port(params, tcfg, num_slots=2, paged=True, page_size=8,
                          max_preemptions=1, telemetry=tel), prompts, max_new=8,
                    priorities=[1, 1, 0])
    assert srv.scheduler.n_preemptions > 0
    assert trace.validate_events(tel.tracer.events)["requests"] == 3
    names = {e["name"] for e in tel.tracer.events}
    assert {"page_alloc", "page_release"} <= names
    reg = tel.registry
    a = srv.pool.allocator
    assert reg.gauge("kv_pages_total").value == a.n_usable
    assert reg.gauge("kv_pages_free").value == a.n_free
    assert reg.counter("kv_pages_alloc_total").value > 0
    assert reg.counter("kv_pages_freed_total").value == reg.counter("kv_pages_alloc_total").value
    assert reg.counter("kv_spill_bytes_total", kind="packed").value > 0


def test_page_map_copied_only_when_the_table_changes():
    """The decode step's device page map is one tensor, refreshed by a copy
    only after the host table changed."""
    _, tcfg = _cfgs(4)
    pool = PagedKVPool(tcfg, 2, 32, page_size=8, device="cpu")
    dev = pool.page_map_vector()
    slot = pool.alloc()
    pool.admit_pages(slot, "A", list(range(1, 12)), 4, bucket=16)
    assert not dev.any()                     # not refreshed yet
    assert pool.page_map_vector() is dev and torch.equal(dev, torch.from_numpy(pool.page_map))
    dev.zero_()
    pool.page_map_vector()
    assert not dev.any(), "no change since the last refresh: no copy"
    pool.free(slot)
    assert not pool.page_map_vector().any() and pool.allocator.n_free == pool.allocator.n_usable


def test_admit_pages_write_mask_protects_shared_pages():
    _, tcfg = _cfgs(4)
    pool = PagedKVPool(tcfg, 2, 32, page_size=8, device="cpu")
    rng = np.random.default_rng(0)
    p1 = rng.integers(1, tcfg.vocab_size, 16).tolist()
    s1 = pool.alloc()
    n_sh, _, pages1, mask1 = pool.admit_pages(s1, "A", p1, 4, bucket=32)
    assert n_sh == 0 and mask1[:2].all() and not mask1[2:].any()
    pool.seal_slot(s1)
    s2 = pool.alloc()
    n_sh, _, pages2, mask2 = pool.admit_pages(s2, "B", p1 + [7, 8, 9], 4, bucket=32)
    assert n_sh == 2 and not mask2[:2].any() and mask2[2] and not mask2[3:].any()
    assert list(pages2[:2]) == list(pages1[:2])


def test_paged_flag_validation():
    _, tcfg = _cfgs(16)
    _, params = _weights("tiny-160k")
    kw = dict(num_slots=2, max_seq_len=32, device="cpu")
    with pytest.raises(ValueError, match="n_pages requires"):
        Server(params, tcfg, n_pages=8, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Server(params, tcfg, paged=True, prefill_chunk=8, **kw)
    # a sharder with pages: the reference's refusal
    with pytest.raises(ValueError, match="drop one of paged / sharder"):
        Server(params, tcfg, paged=True, sharder=object(), **kw)
    # the step profiler is ported: a paged Server serves and attributes
    tel = Telemetry(profiler=StepProfiler())
    srv = Server(params, tcfg, paged=True, page_size=8, telemetry=tel, **kw)
    srv.submit(list(range(1, 12)), 5)
    srv.run_until_drained()
    names = {r["program"] for r in tel.profiler.summary()}
    assert names == {"prefill_paged[16]", "decode_step"}, names
    with pytest.raises(ValueError):
        PagedKVPool(tcfg, 2, 32, page_size=6, device="cpu")
    with pytest.raises(ValueError):
        PagedKVPool(tcfg, 2, 36, page_size=8, device="cpu")
    srv = Server(params, tcfg, paged=True, page_size=8, n_pages=3, **kw)
    with pytest.raises(ValueError, match="pages worst-case"):
        srv.submit(list(range(1, 12)), 8)           # 3 pages, the pool holds 2
    srv = Server(params, tcfg, num_slots=1, max_seq_len=16, paged=True, page_size=8,
                 device="cpu")
    rid = srv.submit(list(range(1, 9)), max_new=9)  # 8 + 9 - 1 == 16 fits exactly
    assert len(srv.run_until_drained()[rid]) == 9
    with pytest.raises(ValueError, match="cache positions"):
        srv.submit(list(range(1, 9)), max_new=10)


def test_shared_prefix_workload_is_deterministic_and_shares_prefixes():
    reqs = synthetic.shared_prefix_workload(256, 12, n_prefixes=2, prefix_len=24,
                                            suffix_len=6, seed=5, device="cpu")
    again = synthetic.shared_prefix_workload(256, 12, n_prefixes=2, prefix_len=24,
                                             suffix_len=6, seed=5, device="cpu")
    assert [r["prompt"].tolist() for r in reqs] == [r["prompt"].tolist() for r in again]
    arrivals = [r["arrival_time"] for r in reqs]
    assert arrivals == sorted(arrivals)
    for r in reqs:
        assert len(r["prompt"]) == 30 and 8 <= r["max_new"] <= 16 and r["priority"] == 0
        head = [s for s in reqs if s["prefix_id"] == r["prefix_id"]][0]
        assert r["prompt"][:24].tolist() == head["prompt"][:24].tolist()
    assert len({r["prefix_id"] for r in reqs}) == 2
