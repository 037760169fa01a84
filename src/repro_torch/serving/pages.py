"""Paged quantized KV cache with copy-on-write prefix sharing — port of
``repro/serving/pages.py``.

``SlotKVCache`` (kvcache.py) gives every request a row of ``cache_len``
positions, so memory is reserved for each request's worst case and two
requests sharing a system prompt store it twice.  This pool replaces the row
with a PAGE TABLE over one pool of fixed-size pages.  The k-bit cache packs
codes and scales along the feature dim only, never across tokens, so any
page boundary on the token axis gives self-contained packed pages: a page
can be shared, spilled or restored as opaque packed bytes.

Device layout: one ``lm.init_caches(cfg, n_pages, ps, per_slot=True)``
tree, the batch axis read as physical pages:

    k_packed  int32 [n_layers, n_pages, ps, n_words]
    k_scales  bf16  [n_layers, n_pages, ps, n_blocks]   (+ v twin)
    pos       int32 [n_layers, n_pages, ps]
    page_map  int32 [num_slots, P_max] on the host (P_max = cache_len / ps),
              mirrored in one device buffer the decode step reads

Row b's position p lives in page ``page_map[b, p // ps]`` at offset
``p % ps``.  The decode step writes through the map
(``attention.write_cache_paged``) and reads through it
(``attention.paged_decode_attention``: on the card the fused attention
follows the map itself), so a paged step computes the slot pool's step on
the same tokens.

Page 0 is the TRASH page: never allocated.  Every write that must land
nowhere (idle decode rows, masked prefill pages) goes there with pos -1.
Every FREE page holds pos -1 at all offsets (``init_caches`` starts so;
``_wipe_pages`` restores it when a page's last reference goes), so a page
popped from the free list is invisible to attention until tokens are
written into it.

Copy-on-write prefix sharing: after a prefill every FULL prompt page is
sealed under a key of the token prefix it holds and the prefill bucket.  A
later admission whose prompt starts with the same tokens forks those pages
by refcount instead of storing them again; its own writes (prompt tail,
decode positions) go to private pages.  Preemption spills only the private
suffix (whole packed pages, as stored) and keeps the sealed prefix by
refcount; the restore is bit-exact.

Admission allocates the whole worst case, ceil((L + max_new - 1) / ps)
pages, so a running request never runs out of pages mid-decode: admission
is the only place capacity is enforced.

``PageAllocator`` is the pure-host half (free list, refcounts, tables, the
COW index), a copy of the reference's.  ``PagedKVPool`` wraps it around the
device tree behind ``SlotKVCache``'s interface, so ``Server`` runs on
either pool.

``sharder=`` places the pool on a mesh as the reference does
(``Sharder.shard_caches(paged=True)``: pages over the data axes, the
intra-page token axis whole); the Server refuses paged serving with a
sharder, as the reference's, so nothing serves from a placed pool yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.serving.kvcache import KV_KEYS, SlotKVCache
from repro_torch.serving.telemetry import NOOP


def prefix_page_keys(prompt, page_size: int, bucket: int) -> list:
    """COW keys for every FULL prompt page, in table order.  Key i covers
    tokens [0, (i + 1) * ps): a page is shareable only with everything
    before it.  The prefill bucket is part of the key: identical prefix
    bytes are promised only between prefills of one padded length.  Exact
    tuples, not hashes: a collision would serve another request's
    context."""
    ps = page_size
    prompt = [int(t) for t in prompt]
    return [(bucket, tuple(prompt[: (i + 1) * ps])) for i in range(len(prompt) // ps)]


class PageAllocator:
    """Host-side page accounting: free list, refcounts, tables, COW index.

    Pure Python over ints.  Page 0 (trash) is never handed out.  An owner
    (request id) is either active (``tables[owner]`` holds its full page
    table) or preempted (``retained[owner]`` holds only the sealed shared
    prefix whose refcounts it keeps across the spill)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        # pop() -> lowest id first; page 0 excluded forever
        self.free: list[int] = list(range(n_pages - 1, 0, -1))
        self.ref: dict[int, int] = {}
        self.tables: dict[object, list[int]] = {}
        self.retained: dict[object, list[int]] = {}
        self.prefix_index: dict[object, int] = {}
        self.page_key: dict[int, object] = {}
        self.alloc_total = 0
        self.freed_total = 0
        self.cow_hits = 0

    # -- capacity ---------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_usable(self) -> int:
        """Pool capacity without the trash page."""
        return self.n_pages - 1

    @property
    def n_shared(self) -> int:
        """Pages referenced by more than one sequence."""
        return sum(1 for c in self.ref.values() if c > 1)

    @property
    def n_resident(self) -> int:
        """Sequences holding pages (active and preempted retainers)."""
        return len(self.tables) + len(self.retained)

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages of a request: positions [0, L + max_new - 1)
        are written (the prompt and all but the last sampled token)."""
        return -(-(prompt_len + max_new - 1) // self.page_size)

    def lookup(self, keys) -> list[int]:
        """Sealed pages for the leading run of ``keys`` (page i is usable
        only with pages 0..i-1)."""
        out = []
        for k in keys:
            p = self.prefix_index.get(k)
            if p is None:
                break
            out.append(p)
        return out

    def can_admit(self, n_new: int) -> bool:
        return n_new <= self.n_free

    # -- lifecycle --------------------------------------------------------
    def admit(self, owner, keys, n_total: int):
        """Build ``owner``'s table: fork the shareable prefix by refcount,
        then pop fresh pages for the rest.  Returns (table, n_shared)."""
        assert owner not in self.tables and owner not in self.retained, \
            f"owner {owner!r} already holds pages"
        shared = self.lookup(keys)[:n_total]
        n_new = n_total - len(shared)
        if n_new > self.n_free:
            raise RuntimeError(f"out of pages: need {n_new} fresh, have {self.n_free} "
                               f"(can_admit() is the admission gate)")
        for p in shared:
            self.ref[p] += 1
        self.cow_hits += len(shared)
        fresh = [self.free.pop() for _ in range(n_new)]
        for p in fresh:
            self.ref[p] = 1
        self.alloc_total += n_new
        table = shared + fresh
        self.tables[owner] = table
        return table, len(shared)

    def seal(self, owner, keys) -> int:
        """Publish ``owner``'s full prompt pages in the COW index (pages
        another owner sealed first keep their key).  Returns pages newly
        sealed.  Runs before the owner can be preempted: a sealed prefix is
        what preemption retains."""
        table = self.tables[owner]
        sealed = 0
        for i, k in enumerate(keys):
            page = table[i]
            if k not in self.prefix_index:
                self.prefix_index[k] = page
                self.page_key[page] = k
                sealed += 1
        return sealed

    def private_suffix(self, owner) -> tuple[list[int], list[int]]:
        """(sealed prefix, private suffix) of an active owner's table.
        Sealed pages form a prefix: ``admit`` puts shared pages first and
        ``seal`` publishes table[:n_keys]."""
        table = self.tables[owner]
        k = 0
        while k < len(table) and table[k] in self.page_key:
            k += 1
        return table[:k], table[k:]

    def detach_private(self, owner) -> list[int]:
        """Preempt: drop the private suffix (the caller spills it first),
        keep the sealed prefix's refcounts.  Returns the pages freed
        (refcount 0), for the position wipe."""
        prefix, private = self.private_suffix(owner)
        del self.tables[owner]
        self.retained[owner] = prefix
        return self._drop_all(private)

    def resume(self, owner, n_private: int) -> list[int]:
        """Un-preempt: ``n_private`` fresh pages behind the retained prefix.
        Returns the new table."""
        prefix = self.retained.pop(owner)
        if n_private > self.n_free:
            self.retained[owner] = prefix
            raise RuntimeError(f"out of pages: resume needs {n_private}, have {self.n_free}")
        fresh = [self.free.pop() for _ in range(n_private)]
        for p in fresh:
            self.ref[p] = 1
        self.alloc_total += n_private
        table = prefix + fresh
        self.tables[owner] = table
        return table

    def release(self, owner) -> list[int]:
        """Retire: drop every reference ``owner`` holds (active or
        retained).  Returns the pages freed.  A sealed page leaves the COW
        index with its last reference, so the index never pins memory."""
        table = self.tables.pop(owner, None)
        if table is None:
            table = self.retained.pop(owner)
        return self._drop_all(table)

    def _drop_all(self, pages) -> list[int]:
        freed = []
        for p in pages:
            self.ref[p] -= 1
            if self.ref[p] == 0:
                del self.ref[p]
                key = self.page_key.pop(p, None)
                if key is not None:
                    del self.prefix_index[key]
                self.free.append(p)
                freed.append(p)
        self.freed_total += len(freed)
        return freed


def scatter_pages(pool, cc, pages, write_mask, length: int, page_size: int) -> None:
    """Write a batch-1 prefill cache ``cc`` (length Sb) into the page-major
    pool leaves, in place.  ``pages`` [Sb // ps] holds the physical page of
    each logical prompt page and ``write_mask`` is True exactly for the
    pages this request owns and must fill; the others (COW-shared prefix
    pages, which are never rewritten, and bucket padding) are not written.
    Stored positions outside [0, length) become -1, as ``scatter_row``
    makes them."""
    sel = np.flatnonzero(np.asarray(write_mask))
    if not len(sel):
        return
    dev = pool[0]["pos"].device
    target = torch.as_tensor(np.asarray(pages, dtype=np.int64)[sel], device=dev)
    src = torch.as_tensor(sel, dtype=torch.int64, device=dev)
    for pl, cl in zip(pool, cc):
        for key, dst in pl.items():
            ca = cl[key]
            if key == "pos":
                n_l, sb = ca.shape
                cw = ca.reshape(n_l, sb // page_size, page_size).index_select(1, src)
                valid = (cw >= 0) & (cw < length)
                dst.index_copy_(1, target, torch.where(valid, cw, torch.full_like(cw, -1)))
            else:
                n_l, _, sb = ca.shape[:3]
                cw = ca[:, 0].reshape((n_l, sb // page_size, page_size) + tuple(ca.shape[3:]))
                dst.index_copy_(1, target, cw.index_select(1, src))


def paged_decode_attn_fn(page_map: torch.Tensor, page_size: int):
    """The ``decode_attn`` hook of ``lm.decode_step`` over the paged pool,
    closing over ``page_map`` [num_slots, P_max]: the pool's device buffer,
    refreshed in place between steps, so one captured step serves every
    table."""

    def decode_attn(q, k_new, v_new, cache, pos, *, cap=0.0, window=0, kvq=None):
        if window:
            raise ValueError("paged caches hold full attention only, not a sliding window")
        attn_mod.write_cache_paged(cache, k_new, v_new, pos, page_map, page_size=page_size,
                                   kvq=kvq)
        return attn_mod.paged_decode_attention(q, cache, pos, page_map, cap=cap, kvq=kvq)

    return decode_attn


class PagedKVPool(SlotKVCache):
    """``SlotKVCache``'s interface over page-table storage (module
    docstring).  ``num_slots`` is still the decode batch width, but a row
    no longer costs ``cache_len`` positions of memory: the KV bytes follow
    ``n_pages`` alone."""

    def __init__(self, cfg, num_slots: int, cache_len: int, dtype=torch.bfloat16, *,
                 page_size: int = 16, n_pages: int | None = None, sharder=None,
                 telemetry=NOOP, device=None):
        if page_size < 1 or (page_size & (page_size - 1)):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        if cache_len % page_size:
            raise ValueError(f"page_size {page_size} must divide cache_len {cache_len}")
        if n_pages is None:
            # the slot pool's token capacity, plus the trash page
            n_pages = num_slots * (cache_len // page_size) + 1
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages_per_seq = cache_len // page_size   # P_max
        self.telemetry = telemetry
        # every position starts at -1: the free-page invariant holds at t0
        self.caches = lm.init_caches(cfg, n_pages, page_size, dtype, per_slot=True,
                                     device=device)
        self._total_bytes = self._kv_bytes()
        if sharder is not None:
            self.caches = sharder.shard_caches(self.caches, n_pages, paged=True)
        self._init_slots()
        self.allocator = PageAllocator(n_pages, page_size)
        self.page_map = np.zeros((num_slots, self.pages_per_seq), np.int32)
        # the decode step's copy of page_map, refreshed when the host table
        # changed since the last refresh (the version counters)
        self._page_map_dev = torch.zeros((num_slots, self.pages_per_seq), dtype=torch.int32,
                                         device=self.device)
        self._map_version = 0
        self._map_synced = 0
        self._slot_meta: dict[int, dict] = {}
        self._freed_seen = 0
        if telemetry.enabled:
            self.record_footprint()

    def _set_table(self, slot: int, table) -> None:
        self.page_map[slot] = 0
        self.page_map[slot, : len(table)] = table
        self._map_version += 1

    def page_map_vector(self) -> torch.Tensor:
        """The device page map the decode step reads: the same tensor every
        call, refreshed by one copy when the host table changed."""
        if self._map_synced != self._map_version:
            self._page_map_dev.copy_(torch.from_numpy(self.page_map))
            self._map_synced = self._map_version
        return self._page_map_dev

    # -- admission planning (host) ---------------------------------------
    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        return self.allocator.pages_needed(prompt_len, max_new)

    def can_admit_pages(self, prompt, max_new: int, bucket: int) -> bool:
        """Would a fresh admission of this request fit now, given what its
        prefix can share?"""
        keys = prefix_page_keys(prompt, self.page_size, bucket)
        n_shared = len(self.allocator.lookup(keys))
        n_total = self.pages_needed(len(prompt), max_new)
        return self.allocator.can_admit(max(0, n_total - n_shared))

    def can_resume_pages(self, n_private: int) -> bool:
        return self.allocator.can_admit(n_private)

    def admit_pages(self, slot: int, owner, prompt, max_new: int, bucket: int):
        """Allocate ``slot``'s table (COW fork and fresh pages) and return
        the prefill scatter's operands: (n_shared, n_new, pages [P_w] int32,
        write_mask [P_w] bool), P_w = bucket / ps."""
        assert self.active[slot], "admit_pages into a free slot"
        ps = self.page_size
        keys = prefix_page_keys(prompt, ps, bucket)
        n_total = self.pages_needed(len(prompt), max_new)
        table, n_shared = self.allocator.admit(owner, keys, n_total)
        n_prompt = -(-len(prompt) // ps)   # pages the prefill covers
        self._slot_meta[slot] = {"owner": owner, "keys": keys}
        self._set_table(slot, table)
        p_w = bucket // ps
        pages = np.zeros(p_w, np.int32)
        pages[:n_prompt] = table[:n_prompt]
        write_mask = np.zeros(p_w, bool)
        write_mask[n_shared:n_prompt] = True
        self._page_gauges(alloc=n_total - n_shared, cow=n_shared)
        return n_shared, n_total - n_shared, pages, write_mask

    def seal_slot(self, slot: int) -> int:
        """Publish the slot's full prompt pages for COW (after its prefill)."""
        meta = self._slot_meta[slot]
        sealed = self.allocator.seal(meta["owner"], meta["keys"])
        self._page_gauges()
        return sealed

    # -- lifecycle overrides ----------------------------------------------
    def free(self, slot: int) -> int:
        """Release the occupant's pages (unless a spill already detached
        them), wipe the freed pages' positions, free the row.  Returns the
        pages freed."""
        meta = self._slot_meta.pop(slot, None)
        n_freed = 0
        if meta is not None and meta["owner"] in self.allocator.tables:
            freed = self.allocator.release(meta["owner"])
            self._wipe_pages(freed)
            n_freed = len(freed)
        self._set_table(slot, [])
        super().free(slot)
        self._page_gauges()
        return n_freed

    def room(self, slot: int) -> int:
        """Positions left inside the slot's allocated pages (> 0 for the
        whole budget, by full preallocation; the server keeps the check)."""
        table = self.allocator.tables[self._slot_meta[slot]["owner"]]
        return len(table) * self.page_size - int(self.next_pos[slot])

    def spill_slot(self, slot: int) -> dict:
        """Preempt: copy the PRIVATE page suffix to host memory as stored
        (whole packed pages, never dequantized) and drop those pages; the
        sealed prefix stays resident by refcount.  The record carries what
        ``restore_slot`` needs to rebuild the table bit for bit on fresh
        pages."""
        assert self.active[slot], "spill of a free slot"
        prefix, private = self.allocator.private_suffix(self._slot_meta[slot]["owner"])
        rows = self.private_rows(slot)
        meta = self._slot_meta.pop(slot)
        owner = meta["owner"]
        freed = self.allocator.detach_private(owner)
        self._wipe_pages(freed)
        packed = logical = 0
        for group in rows:
            for key, row in group.items():
                if key in KV_KEYS:
                    b, lb = self._kv_bytes_of(key, row)
                    packed += b
                    logical += lb
        if self.telemetry.enabled:
            self.telemetry.inc("kv_spill_bytes_total", packed, kind="packed")
            self.telemetry.inc("kv_spill_bytes_total", logical, kind="logical")
        self._page_gauges()
        return {"rows": rows, "next_pos": int(self.next_pos[slot]), "owner": owner,
                "keys": meta["keys"], "n_private": len(private), "n_retained": len(prefix),
                "bytes_packed": packed, "bytes_logical": logical}

    def restore_slot(self, slot: int, spill: dict) -> None:
        """Resume: fresh private pages, the spilled pages written onto them
        whole (positions included, so nothing of an earlier tenant is
        left), and the table rebuilt."""
        assert self.active[slot], "restore into a free slot: alloc first"
        owner = spill["owner"]
        table = self.allocator.resume(owner, spill["n_private"])
        fresh = torch.as_tensor(table[spill["n_retained"]:], dtype=torch.int64,
                                device=self.device)
        for group, rows in zip(self.caches, spill["rows"]):
            for key, leaf in group.items():
                leaf.index_copy_(1, fresh, rows[key].to(self.device))
        self._slot_meta[slot] = {"owner": owner, "keys": spill["keys"]}
        self._set_table(slot, table)
        self.next_pos[slot] = spill["next_pos"]
        self._page_gauges(alloc=spill["n_private"])

    def private_rows(self, slot: int) -> list:
        """The slot's private pages as stored, copied to host memory: [{key:
        [n_layers, n_private, ps, ...]}] a layer group.  ``spill_slot``'s
        rows; alone it detaches nothing (a restore's check reads it)."""
        _, private = self.allocator.private_suffix(self._slot_meta[slot]["owner"])
        idx = torch.as_tensor(private, dtype=torch.int64, device=self.device)
        return [{key: leaf.index_select(1, idx).to("cpu") for key, leaf in group.items()}
                for group in self.caches]

    # -- device position wipe ---------------------------------------------
    def _wipe_pages(self, pages) -> None:
        """Restore the free-page invariant (pos -1 everywhere) on
        just-freed pages."""
        if not pages:
            return
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        for group in self.caches:
            group["pos"].index_fill_(1, idx, -1)

    # -- telemetry ---------------------------------------------------------
    def _page_gauges(self, alloc: int = 0, cow: int = 0) -> None:
        if not self.telemetry.enabled:
            return
        t = self.telemetry
        a = self.allocator
        t.set_gauge("kv_pages_total", a.n_usable)
        t.set_gauge("kv_pages_free", a.n_free)
        t.set_gauge("kv_pages_shared", a.n_shared)
        t.set_gauge("kv_pages_seqs_resident", a.n_resident)
        if alloc:
            t.inc("kv_pages_alloc_total", alloc)
        if cow:
            t.inc("kv_pages_cow_hits_total", cow)
        freed = a.freed_total - self._freed_seen
        if freed:
            t.inc("kv_pages_freed_total", freed)
        self._freed_seen = a.freed_total

    def record_footprint(self) -> None:
        super().record_footprint()
        self._page_gauges()
