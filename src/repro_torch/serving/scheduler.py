"""Request scheduler for continuous batching: SLA-aware admission —
priority classes with per-class FIFO, anti-starvation aging, and
preemption bookkeeping.  A copy of ``repro/serving/scheduler.py`` (pure
host-side Python), with ``NOOP`` taken from the port's telemetry.

The scheduler is pure host-side policy — it never touches device arrays
(the torchprime config-over-model-code idiom: the jitted model steps are
byte-identical under every policy here).  The server (server.py) asks it
a few questions each engine step:

    next_admissible(now)   which queued request may enter a free slot at
                           virtual time `now`?
    preemption_victim(req) which running slot (if any) should be evicted
                           to make room for `req`?
    bind / preempt / retire  bookkeeping as requests enter, leave, or
                           get evicted from slots
    should_retire(req)     EOS or max_new reached?

Policy:

* **Priority classes** — ``Request.priority`` (0 = most urgent).  Each
  class is its own FIFO deque; admission is strict FIFO *within* a
  class: a request never overtakes an earlier submission of its own
  class, and an unarrived head blocks only its own class (the queue
  models a real per-class ingress order, as the old single-class FIFO
  did globally).
* **Aging** — with ``aging_steps=N``, a queued head's *effective*
  priority improves by one class per N virtual steps waited, so a
  lower class cannot starve behind a steady stream of higher-class
  arrivals.  Aging reorders admission only BETWEEN classes; within a
  class earlier arrivals age at least as much as later ones, so
  per-class FIFO is preserved by construction.
* **Preemption** — when the pool is full, a strictly lower-class
  running request may be evicted for an arriving higher-class one
  (original classes, not aged ones — aging fixes admission order, it
  never triggers evictions, so the preemption relation is acyclic).
  Victims re-queue at the FRONT of their class (ahead of peers that
  never ran) and keep their original ``arrival_time``.  A request is
  evicted at most ``max_preemptions`` times, after which it is immune —
  together with per-class FIFO this guarantees every preempted request
  finishes.  ``max_preemptions=0`` (default) disables preemption and
  reproduces the plain scheduler.

Request lifecycle::

    QUEUED -> RUNNING -> FINISHED
                ^  |
                |  v   (spill / restore of the slot's packed KV rows is
              PREEMPTED  the server's job; kvcache.spill_slot)

Request ids are assigned by ``submit`` from a per-Scheduler counter —
two Schedulers never share an id sequence, so tests (and replays) can
assert on ids without ordering coupling.

A ``telemetry=`` recorder (serving/telemetry.py; defaults to the no-op)
turns the bookkeeping into observable gauges: queue depth (preempted
requests included), running and preempted counts, queue-wait and
preemption counters (docs/observability.md).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

from repro_torch.serving.telemetry import NOOP


QUEUED, RUNNING, PREEMPTED, FINISHED = \
    "QUEUED", "RUNNING", "PREEMPTED", "FINISHED"


@dataclass
class Request:
    """One generation request. `prompt` is a 1-D int sequence (list /
    np.ndarray / jnp.ndarray); `arrival_time` is in virtual engine-step
    units (0 = present from the start); `priority` is the scheduling
    class (0 = most urgent).  `id` is assigned by Scheduler.submit."""

    prompt: object
    max_new: int
    temperature: float = 0.0
    priority: int = 0
    id: int | None = None
    arrival_time: float = 0.0
    on_token: object = None          # callable(request_id, token) or None

    # runtime state (owned by the scheduler / server)
    state: str = QUEUED
    slot: int | None = None
    tokens: list = field(default_factory=list)
    admitted_at: float | None = None      # most recent bind (resume included)
    first_admitted_at: float | None = None  # first bind ever — never reset
    finished_at: float | None = None
    preemptions: int = 0             # times evicted from a slot so far
    # wall-clock telemetry marks (host perf_counter; None until recorded)
    t_submit: float | None = None
    t_first_token: float | None = None
    t_last_token: float | None = None

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.priority < 0:
            raise ValueError("priority must be >= 0 (0 = most urgent)")


class Scheduler:
    def __init__(self, *, eos_id: int | None = None, telemetry=NOOP,
                 aging_steps: int | None = None, max_preemptions: int = 0):
        if aging_steps is not None and aging_steps < 1:
            raise ValueError("aging_steps must be >= 1 (or None to disable)")
        if max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0")
        self.eos_id = eos_id
        self.telemetry = telemetry
        self.aging_steps = aging_steps
        self.max_preemptions = max_preemptions
        self.queues: dict[int, deque[Request]] = {}   # class -> FIFO
        self.running: dict[int, Request] = {}         # slot -> request
        self.finished: list[Request] = []
        self.n_preemptions = 0   # total evictions (host-side, telemetry-free)
        self._ids = itertools.count()  # per-instance: no cross-test leakage

    # -- introspection -----------------------------------------------------
    @property
    def n_queued(self) -> int:
        """Requests waiting for a slot — preempted requests included
        (they re-queue at the front of their class)."""
        return sum(len(q) for q in self.queues.values())

    @property
    def n_preempted(self) -> int:
        return sum(1 for q in self.queues.values()
                   for r in q if r.state == PREEMPTED)

    @property
    def drained(self) -> bool:
        return self.n_queued == 0 and not self.running

    def counts(self) -> dict:
        """Conservation snapshot: submitted == queued + running + finished
        at every instant (the property suite's core invariant)."""
        return {"queued": self.n_queued, "running": len(self.running),
                "finished": len(self.finished),
                "preempted": self.n_preempted}

    def _gauges(self) -> None:
        self.telemetry.set_gauge("serve_queue_depth", self.n_queued)
        self.telemetry.set_gauge("serve_requests_running", len(self.running))
        self.telemetry.set_gauge("serve_requests_preempted", self.n_preempted)

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> Request:
        assert req.state == QUEUED
        if req.id is None:
            req.id = next(self._ids)
        self.queues.setdefault(req.priority, deque()).append(req)
        if self.telemetry.enabled:
            self.telemetry.inc("serve_requests_submitted_total")
            self._gauges()
        return req

    def effective_priority(self, req: Request, now: float) -> float:
        """Class minus one per aging_steps waited (may go below 0 — only
        the relative order matters)."""
        if self.aging_steps is None:
            return req.priority
        waited = max(0.0, now - req.arrival_time)
        return req.priority - int(waited // self.aging_steps)

    def next_admissible(self, now: float) -> Request | None:
        """Best arrived class-head by (effective priority, submit id);
        None if every head is still in the future.  Strict ordering per
        class: later requests never overtake a not-yet-arrived head of
        their own class."""
        best = None
        best_key = None
        for q in self.queues.values():
            if not q or q[0].arrival_time > now:
                continue
            head = q[0]
            key = (self.effective_priority(head, now), head.id)
            if best_key is None or key < best_key:
                best, best_key = head, key
        return best

    def next_arrival(self) -> float | None:
        heads = [q[0].arrival_time for q in self.queues.values() if q]
        return min(heads) if heads else None

    def bind(self, req: Request, slot: int, now: float) -> None:
        q = self.queues.get(req.priority)
        assert q and q[0] is req, "admission must be FIFO within a class"
        q.popleft()
        assert req.state in (QUEUED, PREEMPTED)
        resumed = req.state == PREEMPTED
        first = req.first_admitted_at is None
        req.state = RUNNING
        req.slot = slot
        req.admitted_at = now
        if first:
            req.first_admitted_at = now
        self.running[slot] = req
        if self.telemetry.enabled:
            if first:
                self.telemetry.observe("serve_queue_wait_steps",
                                       max(0.0, now - req.arrival_time))
            if resumed:
                self.telemetry.inc("serve_resumes_total")
            self._gauges()

    # -- preemption --------------------------------------------------------
    def preemption_victim(self, req: Request, now: float,
                          exclude=()) -> int | None:
        """Slot whose request should be evicted so `req` can run, or None.
        Eligible victims run at a STRICTLY worse (higher) original class
        than `req` and have been evicted fewer than max_preemptions
        times; the worst class wins, latest-FIRST-admitted among ties
        (it has the least sunk work).  The tiebreak reads
        ``first_admitted_at``, not ``admitted_at``: a resume refreshes
        the latter, so keying on it would re-pick the request that just
        restored as "least sunk" every time — repeated preemption of the
        same victim until its max_preemptions immunity, i.e. starvation
        by eviction.  First-admission time is preemption-invariant.
        `exclude` masks slots the server cannot evict (e.g. mid-chunk
        prefills with no cache rows to spill)."""
        if self.max_preemptions <= 0:
            return None
        best = None
        for slot, r in self.running.items():
            if slot in exclude:
                continue
            if r.priority <= req.priority:
                continue
            if r.preemptions >= self.max_preemptions:
                continue
            key = (r.priority, r.first_admitted_at, r.id)
            if best is None or key > best[0]:
                best = (key, slot)
        return best[1] if best else None

    def preempt(self, slot: int, now: float) -> Request:
        """Evict the request bound to `slot` back into its class queue —
        at the front, behind only earlier-submitted preempted peers, so
        resumes keep submit order and never fall behind requests that
        have not run yet.  The caller (server) spills/frees the slot."""
        req = self.running.pop(slot)
        assert req.state == RUNNING
        req.state = PREEMPTED
        req.slot = None
        req.preemptions += 1
        self.n_preemptions += 1
        q = self.queues.setdefault(req.priority, deque())
        i = 0
        while i < len(q) and q[i].state == PREEMPTED and q[i].id < req.id:
            i += 1
        q.insert(i, req)
        if self.telemetry.enabled:
            self.telemetry.inc("serve_preemptions_total")
            self._gauges()
        return req

    # -- retirement --------------------------------------------------------
    def should_retire(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new:
            return True
        return (self.eos_id is not None and len(req.tokens) > 0
                and req.tokens[-1] == self.eos_id)

    def retire(self, slot: int, now: float) -> Request:
        req = self.running.pop(slot)
        req.state = FINISHED
        req.slot = None
        req.finished_at = now
        self.finished.append(req)
        if self.telemetry.enabled:
            self.telemetry.inc("serve_requests_retired_total")
            self._gauges()
        return req
