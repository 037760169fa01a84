"""Every (arch x shape) cell of the dry-run as a program on fake tensors —
port of ``repro/launch/specs.py``.

The reference builds ``ShapeDtypeStruct`` stand-ins and shardings and hands
them to ``jax.jit(...).lower().compile()``.  Here a cell is the port's own
step callable and this rank's arguments as fake tensors
(``torch._subclasses.FakeTensorMode``: shapes, dtypes and devices, no
data), cut by the port's ``Sharder`` on the mesh it is given (on the
dry-run's fake process group: ``launch/dryrun.py``); running it under its
mode costs it (``utils/cost.measure``) without a device or an allocation.

* train: ``init_state(param_dtype=torch.bfloat16)`` with no compression
  error (``err=None``), cut to this rank's FSDP slices
  (``Sharder.shard_train_state``), the step of ``make_train_step(sharder=,
  microbatches=, donate=True)`` (the reference donates its state).
  Microbatches double while more than one sequence a data rank would remain
  (the reference's rule); seamless-m4t trains on S stub frames and
  ``max(S // 4, 16)`` tokens.  The batch is the global one, which every rank
  of the port's step is given: the step takes this rank's rows where the
  batch divides the data ranks and keeps it whole where it does not (the
  reference's ``_batch_sharding``).
* prefill: ``lm.prefill(cache_len=S, constrain=, q_pad=sharder.head_pad())``
  (seamless: ``seq2seq.prefill`` over S frames and 8 ``bos`` tokens), the
  caches cut to this rank's windows after (``shard_caches``), as the
  Engine's prefill program does and as the reference's out-shardings place
  them.
* decode: ``lm.decode_step`` over ``lm.init_caches(cfg, B, S)`` cut by
  ``shard_caches`` and read through ``decode_attn_fn(B, S)``, at a 0-d
  position tensor (the reference's traced scalar); seamless over a self
  cache of ``decoder_cache_len`` slots and a cross cache of S frames
  (``{"k", "v", "pos"}``), read through ``decode_attn_fn`` and
  ``cross_attn_fn``.

Serving cells run on quantized parameters built from shapes
(``quantized_shells``): each unit a QuantizedTensor of fake words, scales
and codebooks at the shapes and dtypes ``quantize_params`` stores, the
encode never run (the reference's ``_quantized_param_shapes``).
"""

from __future__ import annotations

import dataclasses
import inspect
import math

import torch

from repro_torch.configs import QuantConfig, get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.core import packing
from repro_torch.core.qtensor import QuantizedTensor, dtype_name
from repro_torch.models import attention, lm, seq2seq
from repro_torch.models.quantize import _walk_units
from repro_torch.models.sharding import Sharder
from repro_torch.train import step as step_mod

#: serving quantization default — the paper's recommendation (§7):
#: 4-bit, float data type, block size <= 128
SERVE_QUANT = QuantConfig(bits=4, dtype="float", block_size=64)

#: the seamless decoder's BOS prefix in a prefill cell (the reference's)
BOS_LEN = 8


class Skip(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class EngineShape(ShapeConfig):
    """A serving cell as the port's Engine builds its programs, for the
    card's check of the dry-run: the prefill reserves ``cache_len`` slots
    (the Engine's ``max_seq_len``, past the prompt's ``seq_len``), and the
    dense leaves are ``param_dtype`` (the caller's init; the reference's is
    f32)."""
    cache_len: int = 0
    param_dtype: torch.dtype = torch.float32


def build_cell(arch: str, shape, mesh, *, quant: QuantConfig | None = SERVE_QUANT,
               cfg=None, sharder_kw: dict | None = None):
    """dict(fn, args, alias, grad, mode, meta, cfg, sharder) of one cell, or
    raises ``Skip`` (``shape_applicable``'s reason) for a documented
    non-applicable one, before the mesh is touched.  ``fn(*args)`` is the
    step, to run under ``mode`` (the FakeTensorMode that holds ``args``:
    this rank's slices); ``alias`` the indices of the arguments it writes in
    place (the decode caches, the donated train state); ``grad`` whether it
    runs with autograd on (train); ``meta`` = dict(kind, tokens).

    ``shape`` is a name of ``SHAPES``.  For the tests and the card's check
    of the dry-run only: ``shape`` may be a ``ShapeConfig`` (an
    ``EngineShape`` for the Engine's programs), and ``cfg`` a config in
    place of the registry's ``arch`` with ``sharder_kw`` its ``Sharder``
    options (``replicate_params_below``)."""
    return _build_cell(arch, shape, mesh, quant=quant, cfg=cfg, sharder_kw=sharder_kw)


def _build_cell(arch, shape, mesh, *, quant, cfg, sharder_kw, periods=None, micro=None):
    """``build_cell``, and the dry-run's extrapolation points
    (``launch/dryrun.cost_cell``): ``periods`` cuts the stack to that many
    of its scan periods (``cut_depth``; the Sharder replicates or splits as
    for the whole model) and ``micro`` runs that many of a train cell's
    microbatches, each of the rows it has in the whole cell (the global
    batch cut to match); ``meta`` stays the whole cell's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    full = get_arch(arch) if cfg is None else cfg
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(full, shape)
    if not ok:
        raise Skip(why)
    kw = dict(sharder_kw or {})
    cfg = full
    if periods is not None:
        cfg = cut_depth(full, periods)
        below = kw.get("replicate_params_below", inspect.signature(
            Sharder).parameters["replicate_params_below"].default)
        # the whole model's decision: replicate its weights or split them
        kw["replicate_params_below"] = math.inf if full.param_count() * 2 < below else 0
    sharder = Sharder(mesh, cfg, **kw)
    engine = isinstance(shape, EngineShape)
    param_dtype = shape.param_dtype if engine else None
    mode = FakeTensorMode()
    with mode:
        if shape.kind == "train":
            cell = _train_cell(cfg, shape, sharder, micro)
        elif shape.kind == "prefill":
            cell = _prefill_cell(cfg, shape, sharder, quant,
                                 shape.cache_len if engine else shape.seq_len, param_dtype)
        else:
            cell = _decode_cell(cfg, shape, sharder, quant, param_dtype)
    return dict(cell, mode=mode, cfg=full, sharder=sharder)


def cut_depth(cfg, periods: int):
    """``cfg`` with its stack cut to ``periods`` of its scan periods (and an
    encoder-decoder's encoder in proportion), every layer of the cut the
    same as in the whole stack; ValueError where that cannot be."""
    p = cfg.scan_period()
    units = cfg.n_layers // p
    kw = dict(n_layers=periods * p)
    if cfg.encoder_decoder:
        if cfg.n_encoder_layers % units:
            raise ValueError(f"{cfg.name}: {cfg.n_encoder_layers} encoder layers do not "
                             f"scale with {units} decoder periods")
        kw["n_encoder_layers"] = periods * cfg.n_encoder_layers // units
    cut = dataclasses.replace(cfg, **kw)
    if cut.layer_schedule() != cfg.layer_schedule()[:periods * p]:
        raise ValueError(f"{cfg.name}: the first {periods} periods of the stack differ "
                         "from the whole stack's")
    return cut


def _zeros(shape, dtype):
    return torch.zeros(tuple(shape), dtype=dtype, device="cpu")


# -- train ------------------------------------------------------------------

def microbatches(shape: ShapeConfig, dp_size: int) -> int:
    """Gradient accumulation over ``dp_size`` data ranks: at most one
    sequence a data rank a microstep (deep archs' activations stay within
    HBM), the reference's rule."""
    B = shape.global_batch
    micro = 1
    while B // micro > dp_size and micro < B:
        micro *= 2
    return micro


def batch_shapes(cfg, shape: ShapeConfig) -> dict:
    """{name: (shape, dtype)} of a train batch: tokens and labels [B, S], or
    for the encoder-decoder (speech to text) S stub frames [B, S, D] and
    max(S // 4, 16) tokens and labels."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.encoder_decoder:
        T = max(S // 4, 16)
        return {"frames": ((B, S, cfg.d_model), torch.bfloat16),
                "tokens": ((B, T), torch.int32), "labels": ((B, T), torch.int32)}
    return {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}


def _train_cell(cfg, shape, sharder, micro):
    state = step_mod.init_state(cfg, device="cpu", param_dtype=torch.bfloat16)
    state = sharder.shard_train_state(state) if sharder.mesh is not None else state
    whole = microbatches(shape, sharder.dp_size)
    run = shape
    if micro is not None:   # micro of the microbatches, each as in the whole cell
        run = dataclasses.replace(shape, global_batch=shape.global_batch * micro // whole)
    batch = {k: _zeros(s, d) for k, (s, d) in batch_shapes(cfg, run).items()}
    fn = step_mod.make_train_step(cfg, sharder=sharder, microbatches=micro or whole,
                                  donate=True)
    return dict(fn=fn, args=(state, batch), alias=(0,), grad=True,
                meta=dict(kind="train", tokens=shape.global_batch * shape.seq_len,
                          microbatches=whole))


# -- serving ----------------------------------------------------------------

def _shell(kind: str, w: torch.Tensor, q: QuantConfig) -> QuantizedTensor:
    """The QuantizedTensor ``quantize_unit(kind, w, q)`` stores, its fields
    fake tensors of the stored shapes and dtypes (nothing encoded)."""
    if q.centering or q.outlier_pct:
        raise ValueError("quantized shells cover neither centering nor outliers: "
                         f"{q.describe()}")
    matrix = kind in ("matrix", "moe")
    shape = tuple(w.shape[:-2]) + (w.shape[-1], w.shape[-2]) if matrix else tuple(w.shape)
    nb = len(shape) - 2 if matrix else 0
    batch, quant = shape[:nb], shape[nb:]
    structured = len(quant) == 2 and quant[1] % q.block_size == 0
    if structured:
        rows, cols = quant
        packed = (rows, packing.packed_size(cols, q.bits))
        scales = (rows, cols // q.block_size)
    else:
        n_blocks = -(-math.prod(quant) // q.block_size)
        packed = (packing.packed_size(n_blocks * q.block_size, q.bits),)
        scales = (n_blocks,)
    return QuantizedTensor(
        packed=_zeros(batch + packed, torch.int32),
        scales=_zeros(batch + scales, torch.bfloat16), means=None,
        codebook=_zeros(batch + (2 ** q.bits,), torch.float32),
        outlier_vals=None, outlier_idx=None, quant_shape=quant, bits=q.bits,
        block_size=q.block_size, dtype_name=q.dtype, centering=False, outlier_axis=-1,
        transposed=matrix, structured=structured, orig_dtype=dtype_name(w.dtype))


def quantized_shells(cfg, quant: QuantConfig | None = SERVE_QUANT, dtype=None) -> dict:
    """The parameter tree ``quantize_params(init_params(cfg, dtype=dtype),
    quant, cfg)`` gives, from shapes: the same walk over the units, each a
    ``_shell``; the dense leaves as ``init_params`` makes them (f32 weights
    unless ``dtype``).  Call it under a FakeTensorMode (``build_cell``)."""
    init = seq2seq.init_params if cfg.encoder_decoder else lm.init_params
    params = init(cfg, device="cpu", dtype=dtype or torch.float32)
    if quant is None:
        return params
    return _walk_units(params, quant, lambda name, kind, w, container: _shell(kind, w, quant))


def _prefill_cell(cfg, shape, sharder, quant, cache_len, param_dtype):
    B, S = shape.global_batch, shape.seq_len
    params = sharder.shard_params(quantized_shells(cfg, quant, param_dtype))
    constrain, q_pad = sharder.constrain, sharder.head_pad()
    if cfg.encoder_decoder:
        def fn(params, frames, bos):
            logits, caches = seq2seq.prefill(params, frames, bos, cfg, constrain=constrain,
                                             q_pad=q_pad)
            return logits, sharder.shard_caches(caches, B)

        args = (params, _zeros((B, S, cfg.d_model), torch.bfloat16),
                _zeros((B, BOS_LEN), torch.int32))
    else:
        def fn(params, tokens):
            logits, caches = lm.prefill(params, tokens, cfg, cache_len=cache_len,
                                        constrain=constrain, q_pad=q_pad)
            return logits, sharder.shard_caches(caches, B)

        args = (params, _zeros((B, S), torch.int32))
    return dict(fn=fn, args=args, alias=(), grad=False,
                meta=dict(kind="prefill", tokens=B * S))


def seq2seq_caches(cfg, batch: int, source_len: int) -> tuple:
    """(self cache, cross cache) of a seamless decode step, whole: the self
    cache of ``decoder_cache_len`` slots a layer (bf16, positions -1), the
    cross cache's K/V over ``source_len`` frames and their positions."""
    L = cfg.n_layers
    one = attention.init_kv_cache(cfg, batch, cfg.decoder_cache_len, torch.bfloat16,
                                  device="cpu")
    self_c = {k: v.unsqueeze(0).repeat((L,) + (1,) * v.ndim) for k, v in one.items()}
    kv = (L, batch, source_len, cfg.n_kv_heads, cfg.head_dim)
    cross = {"k": _zeros(kv, torch.bfloat16), "v": _zeros(kv, torch.bfloat16),
             "pos": torch.arange(source_len, dtype=torch.int32).expand(L, source_len)
             .contiguous()}
    return self_c, cross


def _decode_cell(cfg, shape, sharder, quant, param_dtype):
    B, S = shape.global_batch, shape.seq_len
    params = sharder.shard_params(quantized_shells(cfg, quant, param_dtype))
    constrain = sharder.constrain
    token, pos = _zeros((B,), torch.int32), torch.tensor(S - 1, dtype=torch.int32)
    if cfg.encoder_decoder:
        caches = sharder.shard_caches(seq2seq_caches(cfg, B, S), B)
        self_read = sharder.decode_attn_fn(B, cfg.decoder_cache_len)
        cross_read = sharder.cross_attn_fn(B, S)

        def fn(params, token, caches, pos):
            return seq2seq.decode_step(params, token, caches, pos, cfg, constrain=constrain,
                                       decode_attn=self_read, cross_attn=cross_read)
    else:
        caches = sharder.shard_caches(lm.init_caches(cfg, B, S, device="cpu"), B)
        read = sharder.decode_attn_fn(B, S)

        def fn(params, token, caches, pos):
            return lm.decode_step(params, token, caches, pos, cfg, decode_attn=read,
                                  constrain=constrain)
    return dict(fn=fn, args=(params, token, caches, pos), alias=(2,), grad=False,
                meta=dict(kind="decode", tokens=B))
