"""The port's scheduler, trace and telemetry against the JAX package's.

``repro_torch.serving.scheduler``, ``trace`` and ``telemetry`` are copies of
the reference's pure-Python modules with their imports repointed, so they
are held to identity: the same seeded traffic, driven through both
schedulers by one virtual-clock harness (the way the Server drives them:
admit into a fake slot set, preempt when full, one token per running
request a step, scripted EOS), gives the same admission, preemption and
retire order; the property tests of ``tests/test_scheduler_properties.py``
hold for the port's scheduler; a trace and a metrics registry written by
one package read back the same in the other.
"""

import json

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # the property tests skip; the seeded cases still run
    HAVE_HYPOTHESIS = False

from repro.serving import scheduler as r_sched  # noqa: E402
from repro.serving import telemetry as r_tel  # noqa: E402
from repro.serving import trace as r_trace  # noqa: E402
from repro_torch.serving import scheduler as t_sched  # noqa: E402
from repro_torch.serving import telemetry as t_tel  # noqa: E402
from repro_torch.serving import trace as t_trace  # noqa: E402

PACKAGES = {"reference": (r_sched, r_tel), "port": (t_sched, t_tel)}


def _check_invariants(mod, sch, n_slots, free, n_submitted):
    c = sch.counts()
    assert n_submitted == c["queued"] + c["running"] + c["finished"]
    assert sorted(sorted(sch.running) + free) == list(range(n_slots))
    assert c["preempted"] <= c["queued"]
    for q in sch.queues.values():
        for r in q:
            assert r.state in (mod.QUEUED, mod.PREEMPTED)
    for r in sch.running.values():
        assert r.state == mod.RUNNING
    for r in sch.finished:
        assert r.state == mod.FINISHED
    if sch.telemetry.enabled:
        reg = sch.telemetry.registry
        assert reg.gauge("serve_queue_depth").value == c["queued"]
        assert reg.gauge("serve_requests_running").value == c["running"]
        assert reg.gauge("serve_requests_preempted").value == c["preempted"]


def simulate(pkg, specs, *, n_slots, aging_steps=None, max_preemptions=0, telemetry=False,
             eos_id=None, eos_after=None):
    """Drive package ``pkg``'s Scheduler over ``specs`` = [(priority, arrival,
    max_new)] with a fake slot set, checking the invariants at every step.
    Returns (scheduler, first admissions, log of (event, id, slot, step))."""
    mod, tel = PACKAGES[pkg]
    sch = mod.Scheduler(eos_id=eos_id, telemetry=tel.Telemetry() if telemetry else tel.NOOP,
                        aging_steps=aging_steps, max_preemptions=max_preemptions)
    reqs = [sch.submit(mod.Request(prompt=[1], max_new=m, priority=p, arrival_time=float(a)))
            for p, a, m in specs]
    eos_after = eos_after or {}
    idx = {r.id: i for i, r in enumerate(reqs)}
    max_steps = 50 + 20 * len(specs) + int(max((a for _, a, _ in specs), default=0))
    free = list(range(n_slots))
    first, log = [], []
    now = 0

    def emit(req, slot):
        n = len(req.tokens)
        req.tokens.append(eos_id if eos_id is not None
                          and n >= eos_after.get(idx[req.id], 1 << 30) else 0)
        if sch.should_retire(req):
            sch.retire(slot, now)
            free.append(slot)
            log.append(("retire", req.id, slot, now))

    while not sch.drained:
        assert now < max_steps, f"starvation: not drained after {max_steps} steps"
        while True:
            req = sch.next_admissible(now)
            if req is None:
                break
            if not free:
                v = sch.preemption_victim(req, now)
                if v is None:
                    break
                victim = sch.preempt(v, now)
                assert victim.priority > req.priority
                assert victim.preemptions <= max_preemptions
                free.append(v)
                log.append(("preempt", victim.id, v, now))
            slot = free.pop()
            fresh = req.state == mod.QUEUED
            sch.bind(req, slot, now)
            log.append(("bind", req.id, slot, now))
            if fresh:
                first.append(req.id)
                emit(req, slot)
            _check_invariants(mod, sch, n_slots, free, len(reqs))
        for slot, req in list(sch.running.items()):
            emit(req, slot)
        _check_invariants(mod, sch, n_slots, free, len(reqs))
        now += 1
        if not sch.running and sch.n_queued:
            nxt = sch.next_arrival()
            if nxt is not None and nxt > now:
                now = int(np.ceil(nxt))
    assert len(sch.finished) == len(reqs)
    for r in sch.finished:
        assert 1 <= len(r.tokens) <= r.max_new
    for cls in {p for p, _, _ in specs}:
        ids = [i for i in first if reqs[idx[i]].priority == cls]
        assert ids == sorted(ids), f"class {cls} admissions broke FIFO: {ids}"
    return sch, first, log


def _seeded_specs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 20))
    return sorted([(int(rng.integers(0, 3)), int(rng.integers(0, 30)), int(rng.integers(1, 6)))
                   for _ in range(n)], key=lambda s: s[1])


@pytest.mark.parametrize("n_slots,aging,max_preemptions,seed", [
    (1, None, 0, 0), (2, 4, 0, 1), (2, 4, 1, 2), (3, None, 2, 3), (1, 2, 2, 4), (4, 8, 1, 5),
    (2, 4, 2, 6), (3, 2, 3, 7),
])
def test_same_order_as_reference(n_slots, aging, max_preemptions, seed):
    """Same traffic, same admission, preemption and retire log, and the
    same registry, through both packages' schedulers."""
    specs = _seeded_specs(seed)
    eos_after = {i: m // 2 for i, (_, _, m) in enumerate(specs) if i % 3 == 0}
    runs = {pkg: simulate(pkg, specs, n_slots=n_slots, aging_steps=aging,
                          max_preemptions=max_preemptions, telemetry=True, eos_id=7,
                          eos_after=eos_after) for pkg in PACKAGES}
    (rs, rfirst, rlog), (ts, tfirst, tlog) = runs["reference"], runs["port"]
    assert tlog == rlog and tfirst == rfirst
    assert ts.n_preemptions == rs.n_preemptions
    assert [(r.id, r.tokens, r.preemptions) for r in ts.finished] == \
        [(r.id, r.tokens, r.preemptions) for r in rs.finished]
    assert ts.telemetry.registry.as_dict() == rs.telemetry.registry.as_dict()


@pytest.mark.parametrize("n_slots,aging,max_preemptions,seed", [
    (1, None, 0, 0), (2, 4, 0, 1), (2, 4, 1, 2), (3, None, 2, 3), (1, 2, 2, 4), (4, 8, 1, 5),
])
def test_seeded_traffic_sweep(n_slots, aging, max_preemptions, seed):
    simulate("port", _seeded_specs(seed), n_slots=n_slots, aging_steps=aging,
             max_preemptions=max_preemptions, telemetry=True)


if HAVE_HYPOTHESIS:
    _spec = st.tuples(st.integers(0, 3), st.integers(0, 40), st.integers(1, 6))

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(specs=st.lists(_spec, min_size=1, max_size=24), n_slots=st.integers(1, 4),
           aging=st.sampled_from([None, 2, 8]), max_preemptions=st.integers(0, 2))
    def test_random_traffic_upholds_invariants(specs, n_slots, aging, max_preemptions):
        specs = sorted(specs, key=lambda s: s[1])
        simulate("port", specs, n_slots=n_slots, aging_steps=aging,
                 max_preemptions=max_preemptions, telemetry=True)

    @settings(max_examples=150, deadline=None, derandomize=True)
    @given(specs=st.lists(_spec, min_size=1, max_size=16), n_slots=st.integers(1, 3),
           eos_seed=st.integers(0, 2**31 - 1))
    def test_random_traffic_with_eos_and_preemption(specs, n_slots, eos_seed):
        rng = np.random.default_rng(eos_seed)
        specs = sorted(specs, key=lambda s: s[1])
        eos_after = {i: int(rng.integers(0, m)) for i, (_, _, m) in enumerate(specs)
                     if rng.random() < 0.5}
        simulate("port", specs, n_slots=n_slots, aging_steps=4, max_preemptions=2,
                 telemetry=True, eos_id=7, eos_after=eos_after)

    @settings(max_examples=150, deadline=None, derandomize=True)
    @given(n_shorts=st.integers(1, 12), gap=st.integers(1, 3), long_len=st.integers(8, 30),
           max_preemptions=st.integers(1, 3), n_slots=st.integers(1, 3))
    def test_bounded_starvation_under_preempt_requeue_cycles(n_shorts, gap, long_len,
                                                             max_preemptions, n_slots):
        specs = sorted([(1, 0, long_len)] + [(0, 1 + i * gap, 2) for i in range(n_shorts)],
                       key=lambda s: s[1])
        sch, _, _ = simulate("port", specs, n_slots=n_slots, aging_steps=4,
                             max_preemptions=max_preemptions, telemetry=True)
        lo = next(r for r in sch.finished if r.priority == 1)
        assert lo.preemptions <= max_preemptions and len(lo.tokens) == long_len

    @settings(max_examples=100, deadline=None, derandomize=True)
    @given(specs=st.lists(_spec, min_size=1, max_size=16), n_slots=st.integers(1, 3),
           aging=st.sampled_from([None, 2, 8]), max_preemptions=st.integers(0, 2))
    def test_random_traffic_same_order_as_reference(specs, n_slots, aging, max_preemptions):
        specs = sorted(specs, key=lambda s: s[1])
        kw = dict(n_slots=n_slots, aging_steps=aging, max_preemptions=max_preemptions)
        assert simulate("port", specs, **kw)[2] == simulate("reference", specs, **kw)[2]


def test_class_order_burst():
    specs = [(2, 0, 1), (0, 0, 1), (1, 0, 1), (0, 0, 1), (2, 0, 1), (1, 0, 1)]
    assert simulate("port", specs, n_slots=1)[1] == [1, 3, 2, 5, 0, 4]


def test_forced_preemption_victim_is_worst_class_least_sunk_work():
    sch, _, _ = simulate("port", [(2, 0, 10), (2, 0, 10), (0, 3, 2)], n_slots=2,
                         max_preemptions=1)
    victims = [r for r in sch.finished if r.preemptions > 0]
    assert [v.id for v in victims] == [1]
    assert all(len(r.tokens) == r.max_new for r in sch.finished)


def test_max_preemptions_cap_grants_immunity():
    specs = [(1, 0, 30), (0, 2, 2), (0, 6, 2), (0, 10, 2), (0, 14, 2)]
    sch, _, _ = simulate("port", specs, n_slots=1, max_preemptions=2)
    lo = next(r for r in sch.finished if r.priority == 1)
    assert lo.preemptions == 2 and len(lo.tokens) == 30 and sch.n_preemptions == 2


def test_preemption_disabled_by_default():
    sch, order, _ = simulate("port", [(1, 0, 20), (0, 2, 2)], n_slots=1)
    assert sch.n_preemptions == 0 and order == [0, 1]


def test_aging_lets_background_class_overtake():
    specs = sorted([(0, i, 3) for i in range(12)] + [(1, 0, 1)], key=lambda s: s[1])

    def rank(aging):
        sch, order, _ = simulate("port", specs, n_slots=1, aging_steps=aging)
        return order.index(next(r.id for r in sch.finished if r.priority == 1))

    assert rank(None) == len(specs) - 1
    assert rank(2) < len(specs) - 1


def test_request_validation_and_instance_local_ids():
    with pytest.raises(ValueError):
        t_sched.Request(prompt=[1], max_new=0)
    with pytest.raises(ValueError):
        t_sched.Request(prompt=[1], max_new=1, priority=-1)
    with pytest.raises(ValueError):
        t_sched.Scheduler(aging_steps=0)
    with pytest.raises(ValueError):
        t_sched.Scheduler(max_preemptions=-1)
    a, b = t_sched.Scheduler(), t_sched.Scheduler()
    assert a.submit(t_sched.Request(prompt=[1], max_new=1)).id == 0
    assert b.submit(t_sched.Request(prompt=[1], max_new=1)).id == 0


def _record(tel):
    """A small lifecycle with every kind of record, at fixed times."""
    tel.inc("serve_tokens_total", 3)
    tel.inc("kv_spill_bytes_total", 128, kind="packed")
    tel.set_gauge("serve_slots_active", 2)
    for v in (0.001, 0.02, 0.3, 4.0):
        tel.observe("serve_ttft_seconds", v)
    tel.event("submit", 0.5, request_id=0, step=0, prompt_len=4, max_new=2,
              arrival_time=0.0, priority=0)
    tel.span("queue_wait", 0.5, 0.75, request_id=0, step=0, steps=0.0)
    tel.span("prefill", 0.75, 1.0, request_id=0, step=0, slot=0, prompt_len=4, padded_len=8)
    tel.event("token", 1.0, request_id=0, step=0, first=True)
    tel.span("decode_step", 1.0, 1.25, step=1, n_active=1, batch_fill=0.5)
    tel.event("retire", 1.25, request_id=0, step=1, n_tokens=2, reason="budget")


def test_trace_and_telemetry_round_trip(tmp_path):
    """The same records give the same Prometheus text, registry dict and
    JSONL trace in both packages, and each package validates and reads back
    the other's trace."""
    ref, port = r_tel.Telemetry(), t_tel.Telemetry()
    _record(ref)
    _record(port)
    assert port.registry.prometheus_text() == ref.registry.prometheus_text()
    assert port.registry.as_dict() == ref.registry.as_dict()
    hist = port.registry.histogram("serve_ttft_seconds")
    assert hist.percentile(50) == ref.registry.histogram("serve_ttft_seconds").percentile(50)
    ref.write(trace_out=tmp_path / "ref.jsonl")
    port.write(trace_out=tmp_path / "port.jsonl", metrics_out=tmp_path / "port.prom")
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "ref.jsonl").read_text()
    assert (tmp_path / "port.prom").read_text() == port.registry.prometheus_text()
    events = t_trace.load_jsonl(tmp_path / "ref.jsonl")
    assert events == r_trace.load_jsonl(tmp_path / "port.jsonl")
    assert t_trace.validate_events(events) == r_trace.validate_events(events)
    assert t_trace.validate_jsonl(tmp_path / "ref.jsonl")["requests"] == 1
    assert t_trace.trace_stats(events) == r_trace.trace_stats(events)
    chrome = t_trace.to_chrome_trace(events)
    ref_chrome = r_trace.to_chrome_trace(events)
    ref_chrome["otherData"]["source"] = chrome["otherData"]["source"]
    assert json.dumps(chrome) == json.dumps(ref_chrome)
    assert t_tel.NOOP.enabled is False and t_tel.NOOP.inc("x") is None
    assert t_tel.METRIC_FAMILIES == r_tel.METRIC_FAMILIES
