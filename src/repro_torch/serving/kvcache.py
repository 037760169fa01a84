"""Slot-based KV-cache pool for continuous batching — port of
``repro/serving/kvcache.py``.

The pool owns one decode batch of per-slot caches (``lm.init_caches`` with
``per_slot=True``): each batch row is a *slot* holding one in-flight
request at its own absolute position.  The host tracks which slots are
free and each busy slot's next decode position; the device holds one cache
tree whose tensors never change shape or address, so the server's decode
step is captured once as a CUDA graph over the whole pool.

Lifecycle of a slot:

    alloc() -> slot            pop the lowest free slot
    install_prefill(slot, n)   the server's prefill scattered the row
                               (``scatter_row``); the next position is n
    advance(slot)              one decode step wrote position next_pos
    free(slot)                 push it back; no device work: the stale row
                               is masked by pos = -1 until re-prefilled

``scatter_row`` invalidates positions a prefill did not produce (a prompt
padded to its bucket): entries at positions >= the prompt's length read as
empty (-1).  A k-bit cache moves its packed codes and scales as stored:
``spill_slot`` copies a row to host memory without dequantizing and
``restore_slot`` writes it back bit for bit.

The device-side position vector (``pos_vector``) is one tensor for the
pool's lifetime, refreshed from the host's positions each step, so a
captured step reads it at replay.

Not in this slice: the mesh placement (``sharder=``, ROADMAP A11).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packing import codes_per_word
from repro_torch.kernels.kv_dequant import encode_rows
from repro_torch.models import lm
from repro_torch.serving.telemetry import NOOP

#: cache keys that hold K/V values (as opposed to positions)
KV_KEYS = ("k", "v", "k_packed", "k_scales", "v_packed", "v_scales")


def scatter_row(pool, cc, slot: int, length: int) -> None:
    """Write a batch-1 prefill cache ``cc`` into row ``slot`` of the pool,
    in place.  Both were built with the same cache length: pool leaves
    [n_layers, B, S_c, ...] against cc's [n_layers, 1, S_c, ...]; pool pos
    [n_layers, B, S_c] against cc's shared [n_layers, S_c].  Positions
    outside [0, length) become -1."""
    for pl, cl in zip(pool, cc):
        for key, dst in pl.items():
            src = cl[key]
            if key == "pos":
                valid = (src >= 0) & (src < length)
                dst[:, slot] = torch.where(valid, src, torch.full_like(src, -1))
            else:
                dst[:, slot] = src[:, 0]


def workspace_to_row(workspace, cache_len: int, kvq):
    """A dense bf16 chunked-prefill workspace (``lm.init_caches`` of the
    kv16 twin config, batch 1, the bucket length Sb) as the batch-1 cache
    ``scatter_row`` takes from a plain prefill: length ``cache_len``, packed
    codes and scales when ``kvq`` is a k-bit spec.  ``encode_rows`` sees the
    rows ``write_cache_prefill`` would have encoded, so the committed packed
    row is the plain path's."""
    cc = []
    for layer in workspace:
        k, v, pos = layer["k"], layer["v"], layer["pos"]
        n_l, b1, sb = k.shape[:3]
        pos_full = torch.full((n_l, cache_len), -1, dtype=torch.int32, device=pos.device)
        pos_full[:, :sb] = pos
        if kvq is not None:
            feat = k.shape[-2] * k.shape[-1]
            rows = {}
            for name, x in (("k", k), ("v", v)):
                packed, scales = encode_rows(x.reshape(n_l, b1, sb, feat), kvq)
                rows[f"{name}_packed"], rows[f"{name}_scales"] = packed, scales
        else:
            rows = {"k": k, "v": v}
        out = {}
        for key, x in rows.items():
            full = torch.zeros(x.shape[:2] + (cache_len,) + x.shape[3:], dtype=x.dtype,
                               device=x.device)
            full[:, :, :sb] = x
            out[key] = full
        out["pos"] = pos_full
        cc.append(out)
    return tuple(cc)


class SlotKVCache:
    """A fixed pool of ``num_slots`` decode slots over per-slot caches."""

    def __init__(self, cfg, num_slots: int, cache_len: int, dtype=torch.bfloat16, *,
                 telemetry=NOOP, device=None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.telemetry = telemetry
        self.caches = lm.init_caches(cfg, num_slots, cache_len, dtype, per_slot=True,
                                     device=device)
        self.device = self.caches[0]["pos"].device
        self._free = list(range(num_slots - 1, -1, -1))   # pop() -> lowest id
        self.active = np.zeros(num_slots, dtype=bool)
        # absolute position of the next token fed to each slot (-1 = idle)
        self.next_pos = np.full(num_slots, -1, dtype=np.int64)
        self._pos_dev = torch.full((num_slots,), -1, dtype=torch.int32, device=self.device)
        if telemetry.enabled:
            self.record_footprint()

    # -- host-side bookkeeping -------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        slot = self._free.pop()
        assert not self.active[slot], f"slot {slot} double-alloc"
        self.active[slot] = True
        if self.telemetry.enabled:
            self.telemetry.set_gauge("serve_slots_active", self.n_active)
        return slot

    def free(self, slot: int) -> None:
        assert self.active[slot], f"slot {slot} double-free"
        self.active[slot] = False
        self.next_pos[slot] = -1
        self._free.append(slot)
        if self.telemetry.enabled:
            self.telemetry.set_gauge("serve_slots_active", self.n_active)

    # -- device-side cache ops -------------------------------------------
    def install_prefill(self, slot: int, prompt_len: int) -> None:
        """Mark ``slot``, whose row the server's prefill has just scattered,
        as holding ``prompt_len`` positions."""
        assert self.active[slot], "install_prefill into a free slot"
        self.next_pos[slot] = prompt_len

    def advance(self, slot: int) -> None:
        self.next_pos[slot] += 1

    def pos_vector(self) -> torch.Tensor:
        """[num_slots] int32 decode positions on the device, -1 for idle
        rows (their writes land at a clamped slot with pos -1 and their
        attention output is a masked zero).  The same tensor every call,
        refreshed from the host's positions by one copy."""
        pos = np.where(self.active, self.next_pos, -1).astype(np.int32)
        self._pos_dev.copy_(torch.from_numpy(pos))
        return self._pos_dev

    def room(self, slot: int) -> int:
        """Decode positions left before this slot hits the cache budget."""
        return self.cache_len - int(self.next_pos[slot])

    def _kv_bytes_of(self, key: str, t: torch.Tensor) -> tuple[int, int]:
        """(stored, bf16-equivalent) bytes of a K/V leaf or row."""
        stored = t.numel() * t.element_size()
        if key in ("k", "v"):
            return stored, t.numel() * 2
        if key in ("k_packed", "v_packed"):
            return stored, t.numel() * codes_per_word(self.cfg.kv_bits) * 2
        return stored, 0

    def spill_slot(self, slot: int) -> dict:
        """Copy row ``slot`` of every cache leaf to host memory as stored:
        packed code words and scales for a k-bit cache, never dequantized,
        so ``restore_slot`` is bit-exact and a kv4 spill moves about 4/16 of
        the bf16-equivalent bytes.  Returns {"rows": [{key: tensor}] a
        layer group, "next_pos", "bytes_packed", "bytes_logical"}."""
        assert self.active[slot], "spill of a free slot"
        rows = [{key: leaf[:, slot].to("cpu", copy=True) for key, leaf in group.items()}
                for group in self.caches]
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
        return {"rows": rows, "next_pos": int(self.next_pos[slot]),
                "bytes_packed": packed, "bytes_logical": logical}

    def restore_slot(self, slot: int, spill: dict) -> None:
        """Write a spill record back into (re-allocated) row ``slot``.  Every
        stored position of the row is overwritten, so whatever a later
        occupant or an idle row's clamped write left there is erased."""
        assert self.active[slot], "restore into a free slot: alloc first"
        assert len(spill["rows"]) == len(self.caches), "spill/pool layout mismatch"
        for group, rows in zip(self.caches, spill["rows"]):
            assert rows.keys() == group.keys(), "spill/pool layout mismatch"
            for key, leaf in group.items():
                leaf[:, slot].copy_(rows[key])
        self.next_pos[slot] = spill["next_pos"]

    def kv_bytes(self) -> dict:
        """Resident bytes of the pool's K/V leaves (packed codes and scales
        for a k-bit cache; positions excluded), their bf16-equivalent
        ``logical`` bytes and the compression between them."""
        total = logical = 0
        for group in self.caches:
            for key, leaf in group.items():
                if key in KV_KEYS:
                    b, lb = self._kv_bytes_of(key, leaf)
                    total += b
                    logical += lb
        return {"total": total, "per_device": total, "logical": logical,
                "compression": logical / max(total, 1),
                "per_slot": total / max(self.num_slots, 1),
                "per_token": total / max(self.num_slots * self.cache_len, 1)}

    def record_footprint(self) -> None:
        """Export kv_bytes() and slot occupancy as gauges."""
        kvb = self.kv_bytes()
        t = self.telemetry
        t.set_gauge("kv_pool_bytes", kvb["total"], kind="packed")
        t.set_gauge("kv_pool_bytes", kvb["logical"], kind="logical")
        t.set_gauge("kv_pool_bytes", kvb["per_device"], kind="per_device")
        t.set_gauge("kv_pool_compression_x", kvb["compression"])
        t.set_gauge("serve_slots_total", self.num_slots)
        t.set_gauge("serve_slots_active", self.n_active)
