"""Program costs for the roofline: FLOPs and HBM bytes of one call of a
serving program — the counterpart of ``repro/utils/hlo.py``.

The reference reads the three roofline inputs off a compiled program's XLA
text.  An eager PyTorch program has no such text, so ``measure`` runs the
program once and counts as it goes, in two ways.

**Every aten op**, through a ``TorchDispatchMode``:

* a view (an op whose output aliases an input: reshape, slice, permute,
  expand, ...) costs nothing, nor does an allocation without data
  (``empty``);
* the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot`` and whatever ``torch.utils.flop_counter``'s registry covers)
  adds 2·M·N·K to ``dot_flops`` and to ``flops``;
* data movement (cat, stack, clone, copies, pads, fills, random draws,
  factories) adds no FLOP; every other op adds one FLOP an output element,
  as the reference's walk counts elementwise ops and reductions
  (``utils/hlo.py:280-286``);
* bytes: an op adds the bytes of its tensor inputs (each tensor once) and
  of its outputs — the reference's "fusion-boundary operands + output"
  rule (``utils/hlo.py:300-305``) with every eager op a boundary;
* a gather (``index``, ``index_select``, ``gather``, ``embedding``) reads
  what it outputs, not the whole tensor it reads from, and an in-place
  write into part of a tensor (``index_put_``, ``index_copy_``,
  ``scatter_``, ``copy_`` into a slice, ...) counts the bytes it writes,
  not the buffer it writes into: a one-row cache write costs one row, not
  the cache.

**Charged units** (``unit``, ``charge``).  Each kernel route — B1's
``ops.qmatmul`` and ``qmatmul_experts``, the fused decode attention, the
KV dequant, the two encodes — and each attention read whose q·kᵀ runs as
elementwise work or in padded pieces (``attention.flash_attention``,
``prefill_chunk_attention``, ``_partials``; ``layers.matmul_rounded``'s
row and column pieces) charges the work of the function from its shapes:
its dot FLOPs as the reference counts them (the unpadded product; every
cache slot the read multiplies, masked ones included), a FLOP a value for
its elementwise work, and the bytes it must move.  Nothing inside a unit
is counted, so the charge is the same whether the CUDA kernel or the plain
version runs.  A program therefore costs the same on the CPU and on the
card wherever the same units run; the counted ops between units may
differ (on the card the decode partials go a row at a time and are
concatenated, which adds the concatenation's bytes).  ``kernel_flops`` and
``kernel_bytes`` are the charged share.

**Collectives** (``collective``): each of ``kernels/ops.py``'s raw
collectives charges ``collective_bytes``, its per-rank payload by the
reference's rule (``utils/hlo.py``: the bytes of the collective's result,
twice for an all-reduce, its reduce and broadcast phases; once for an
all-gather, a reduce-scatter, an all-to-all or a permute), whatever the
size of its group and inside a unit too, since no unit's charge holds one.
The ``torch.distributed`` ops themselves are not counted as aten ops
(their ``c10d`` calls move no HBM bytes of the program's own).  On a mesh
a program is costed on each rank: its FLOPs and bytes are that rank's
slice, its ``collective_bytes`` that rank's payload.

``hbm_bytes`` of an eager program is the traffic of its ops as launched,
one after another: what a fused program would keep on chip is counted each
time one op writes it and the next reads it, so it is an upper estimate
of the bytes a step must move, and the charged share a lower one.

Counting reads shapes and dtypes only, never a value: it does not sync the
host, and it works under ``torch.inference_mode()`` and inside a stream
context.  ``measure`` takes the kernel launches of the run back from the
wrappers' counters (``kernels/launches.py``), so costing a program leaves
them as they were.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["ProgramCost", "charge", "collective", "measure", "nbytes", "unit"]


@dataclass
class ProgramCost:
    """Per-call cost of one serving program (``measure``)."""

    name: str
    flops: float
    dot_flops: float
    hbm_bytes: float
    collective_bytes: float
    kernel_flops: float
    kernel_bytes: float
    cost_s: float

    def roofline_seconds(self, peak_flops: float, hbm_bw: float) -> float:
        """The roofline-predicted call time: the binding term of the
        compute/memory roofline at the given peaks."""
        return max(self.flops / peak_flops, self.hbm_bytes / hbm_bw)


class _Tally:
    def __init__(self):
        self.flops = self.dot_flops = self.hbm_bytes = 0
        self.kernel_flops = self.kernel_bytes = 0
        self.collective_bytes = 0
        self.depth = 0   # open units: nothing inside one is counted


# the open measurement of this thread (``measure`` sets it), which the
# units deep in a program charge to; thread-local, as dispatch modes are
_OPEN = threading.local()


def _open() -> _Tally | None:
    return getattr(_OPEN, "tally", None)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def charge(*, flops: int = 0, dot_flops: int = 0, hbm_bytes: int = 0,
           collective_bytes: float = 0) -> None:
    """Add a unit's work to the open measurement: ``flops`` all of its
    FLOPs, ``dot_flops`` the share of them in products, ``collective_bytes``
    a collective's per-rank payload (counted inside a unit too).  A no-op
    outside a measurement; inside another unit it adds only
    ``collective_bytes``."""
    t = _open()
    if t is None:
        return
    t.collective_bytes += collective_bytes
    if t.depth:
        return
    t.flops += flops
    t.dot_flops += dot_flops
    t.hbm_bytes += hbm_bytes
    t.kernel_flops += flops
    t.kernel_bytes += hbm_bytes


#: the reference's payload factor of each collective (``utils/hlo.py``)
COLLECTIVE_FACTOR = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0,
                     "all_to_all": 1.0, "permute": 1.0}


def collective(kind: str, result: torch.Tensor) -> None:
    """Charge one collective of ``kind`` (a key of ``COLLECTIVE_FACTOR``)
    whose result on this rank is ``result``: its bytes times the kind's
    factor."""
    charge(collective_bytes=COLLECTIVE_FACTOR[kind] * nbytes(result))


def unit(work):
    """Decorator: the function is a charged unit.  ``work`` takes the
    function's arguments and returns ``charge``'s keywords, from shapes
    only; it is called only while a measurement is open."""

    def deco(fn):
        @functools.wraps(fn)
        def charged(*args, **kwargs):
            t = _open()
            if t is None:
                return fn(*args, **kwargs)
            if not t.depth:
                charge(**work(*args, **kwargs))
            t.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                t.depth -= 1

        return charged

    return deco


aten = torch.ops.aten
_MATMUL = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.mv, aten.addmv, aten.dot,
           aten.vdot}
_BIASED = {aten.addmm, aten.baddbmm, aten.addmv}
# outputs that alias an input without the schema saying so, and bookkeeping
_FREE = {aten._unsafe_view, aten.lift_fresh, aten._local_scalar_dense, aten.empty,
         aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
         aten.record_stream, aten.set_, aten.resize_, aten.is_nonzero, aten.equal}
_MOVEMENT = {aten.cat, aten.stack, aten.clone, aten.copy, aten.copy_, aten._copy_from,
             aten._copy_from_and_resize, aten.constant_pad_nd, aten.fill, aten.fill_,
             aten.zero_, aten.zeros, aten.zeros_like, aten.ones, aten.ones_like, aten.full,
             aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full, aten.arange,
             aten.scalar_tensor, aten.lift_fresh_copy, aten.repeat, aten.flip, aten.roll,
             aten.uniform_, aten.normal_, aten.random_, aten.exponential_, aten.bernoulli_,
             aten.rand, aten.randn, aten.randint, aten.rand_like, aten.randn_like}
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding, aten.take}
# in-place writes into part of ``self``: the elements written come from
# the named argument (scatters: the index)
_SCATTER = {aten.index_put_: "values", aten._index_put_impl_: "values",
            aten.index_copy_: "source", aten.index_add_: "source",
            aten.masked_scatter_: "source", aten.index_reduce_: "source",
            aten.scatter_: "index", aten.scatter_add_: "index", aten.scatter_reduce_: "index",
            aten.index_fill_: "index"}


def _registry():
    try:
        from torch.utils.flop_counter import flop_registry
    except ImportError:   # pragma: no cover - every torch 2 has it
        return {}
    return {k: v for k, v in flop_registry.items() if k not in _MATMUL}


_FLOP_FORMULAS = _registry()


def _tensors(x):
    """The tensors of one argument or output (a list of them one deep)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += nbytes(t)
    return total


def _bound_arguments(func, args, kwargs) -> dict:
    named = dict(kwargs)
    for a, v in zip(func._schema.arguments, args):
        named[a.name] = v
    return named


def _dot_flops(packet, args, kwargs, out) -> int | None:
    """2·M·N·K of a product, None for an op that is not one."""
    if packet in _MATMUL:
        mat = args[1] if packet in _BIASED else args[0]
        return 2 * out.numel() * mat.shape[-1]
    formula = _FLOP_FORMULAS.get(packet)
    return None if formula is None else int(formula(*args, **kwargs, out_val=out))


class _Counting(TorchDispatchMode):
    """Counts every op dispatched while it is on and no unit is open."""

    def __init__(self, tally: _Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.tally.depth and func.namespace != "c10d":
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        schema = func._schema
        if packet in _FREE or any(r.alias_info is not None and not r.alias_info.is_write
                                  for r in schema.returns):
            return   # a view, or no data
        t = self.tally
        ins = [x for a in args for x in _tensors(a)] + \
            [x for a in kwargs.values() for x in _tensors(a)]
        outs = _tensors(out)
        mutated = [a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if mutated:
            named = _bound_arguments(func, args, kwargs)
            written = [named[n] for n in mutated if isinstance(named.get(n), torch.Tensor)]
            read = [x for x in ins if all(x is not w for w in written)]
            if packet in _SCATTER:
                src = named.get(_SCATTER[packet])
                n = src.numel() if isinstance(src, torch.Tensor) else written[0].numel()
                t.flops += n
                t.hbm_bytes += _unique_bytes(read) + n * written[0].element_size()
                return
            wbytes = _unique_bytes(written)
            if packet in _MOVEMENT:
                t.hbm_bytes += _unique_bytes(read) + wbytes
                return
            t.flops += sum(w.numel() for w in written)
            t.hbm_bytes += _unique_bytes(ins) + wbytes   # read, then written back
            return
        obytes = sum(nbytes(o) for o in outs)
        if packet in _GATHER:
            index = ins[1:]   # the first tensor is the one read from
            t.flops += sum(o.numel() for o in outs)
            t.hbm_bytes += 2 * obytes + _unique_bytes(index)
            return
        t.hbm_bytes += _unique_bytes(ins) + obytes
        if packet in _MOVEMENT:
            return
        dot = _dot_flops(packet, args, kwargs, out) if outs else None
        if dot is not None:
            t.dot_flops += dot
            t.flops += dot
        else:
            t.flops += sum(o.numel() for o in outs)


def measure(name: str, fn, *args) -> ProgramCost:
    """Run ``fn(*args)`` once, without gradients, and return its cost
    (``name`` labels it).  The run's kernel launches are taken back from
    the wrappers' counters.  Measurements do not nest."""
    from repro_torch.kernels import launches

    if _open() is not None:
        raise RuntimeError("cost.measure does not nest")
    before = launches.snapshot()
    t0 = time.perf_counter()
    tally = _OPEN.tally = _Tally()
    try:
        with torch.no_grad(), _Counting(tally):
            fn(*args)
    finally:
        _OPEN.tally = None
        launches.add([b - a for a, b in zip(launches.snapshot(), before)])
    return ProgramCost(name=name, flops=float(tally.flops), dot_flops=float(tally.dot_flops),
                       hbm_bytes=float(tally.hbm_bytes),
                       collective_bytes=float(tally.collective_bytes),
                       kernel_flops=float(tally.kernel_flops),
                       kernel_bytes=float(tally.kernel_bytes),
                       cost_s=time.perf_counter() - t0)


def attention_work(q_rows: int, heads: int, head_dim: int, keys: int, batch: int):
    """The charge of an attention read: q·kᵀ and p·v over every key it
    multiplies (4·B·H·Sq·Skv·Dh dot FLOPs) and a FLOP a score for the
    softmax."""
    dot = 4 * batch * heads * q_rows * keys * head_dim
    return dot, dot + batch * heads * q_rows * keys
