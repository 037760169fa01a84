"""Sharding policy on a ("data", "model") mesh of ranks — port of
``repro/models/sharding.py`` with explicit ``torch.distributed`` collectives
in place of GSPMD and ``shard_map``.

Placements are the reference's, as tuples with one entry a dimension (an
axis name, a tuple of them, or None): ``param_spec_tree`` and
``cache_spec_tree`` give them, and ``shard_params`` / ``shard_caches`` cut a
whole tree to the slices this rank holds.  Activations stay whole on every
rank between operations; each operation on a slice puts its result back
together with its own collectives:

* weights: a quantized weight is column-parallel on its output rows over
  "model" (B1 on this rank's rows, then an all-gather:
  ``kernels/ops.tp_column_parallel``); a dense one of ``_COL_MODULES`` the
  same on its columns; one of ``_ROW_MODULES`` is split on its input rows,
  and the partial sums are all-reduced (``layers.linear``).  The
  embedding and the head split the vocabulary (``lm.embed_inputs``,
  ``lm.logits_from_hidden``).  FSDP: the reference also splits dense
  leaves over "data"; a serving step reads every weight and a gather is
  exact, so serving keeps them whole along "data" (the spec tuples still
  name it).  A flat (not row-structured) QuantizedTensor stays whole.
* prefill attention: q heads, zero-padded to ``head_pad()`` inside their KV
  groups, split over "model" and the batch over the data axes
  (``constrain``), attended and gathered (``constrain.gather``).
* decode: the KV cache is SEQUENCE-sharded over "model" (and over the
  data axes the batch does not fill: ``decode_plan``), the batch over the
  data axes.  ``decode_attn_fn``'s step writes the new token on the rank
  that owns its slot (``attention.write_cache_local_window``), reads this
  rank's window (a packed one through ``kv_dequant.dequant_kv``, one launch
  of csrc/kv_dequant.cu on the card for K and V), takes the
  flash-decoding partials and combines them over the sequence group
  (``attention.combine_partials``).  Cache lengths that do not divide the
  grid (a ring shorter than it) keep their slots whole and read them with
  ``blocks.local_decode_attn``, with a ``SeqShardFallbackWarning`` at setup
  and at first use.

Training (``train/step.py``, ``TrainPlacement``) stores the train state
FSDP's way: each dense leaf, and its AdamW moments and compression error,
cut over "model" and over "data" by the reference's ``_leaf_spec``, a rank
holding 1/(data x model) of it; norm scales and the leaves the reference
replicates stay whole.  The batch is split over the data axes for the
whole forward and backward (``training()``: ``batch_local``), a leaf is
all-gathered over "data" where it is used (``kernels/ops.Placed.gathered``)
and its gradient reduce-scattered back, which also sums the data ranks'
gradients; a leaf not cut over a data axis has its gradient all-reduced
over it (``TrainPlacement.reduce_grads``).  The collectives differentiate
(``kernels/ops.py``); the loss is the global mean (``batch_sum``).

Mixture-of-experts layers (``models/moe.py``) are expert-parallel: an
expert stack [n_p, E, In, Out] (dense or quantized) is cut on E over
"model" (and, stored for training, on In over "data"); the router is whole.
Every rank routes the whole tokens alike, multiplies its E / tp experts'
capacity buffers (``expert_buffer4``: the expert-batched GEMV at decode,
the prefill GEMM an active expert) and all-gathers the outputs on E before
the combine, whose f32 sum in choice order is the unsharded one's.  SSM
layers (``models/ssm.py``) shard the SSD's heads: ``conv_w`` and the conv
cache are cut on their channels over "model", the recurrent state on its
heads; the conv runs on this rank's channels and is gathered, the SSD on
this rank's heads (``ssm_heads``, ``ssm_dt``; B and C whole, ``ssm_bc``),
and y is gathered whole before the gated RMSNorm over d_inner.  Heads or
channels that do not divide "model" stay whole (``_maybe``).

Every collective is issued whatever the size of its group: a 1x1 mesh runs
the whole machinery (on the card, NCCL at world size 1).  ``replicate``
(models under ``replicate_params_below`` bytes of bf16) and ``Sharder(None,
cfg)`` make every placement a no-op, as in the reference (a replicating
train step still splits the batch over the data axes).

The encoder-decoder (``models/seq2seq.py``) takes the same Sharder: its
leaves (``frame_proj``, ``enc_stack``, ``dec_stack`` with ``self_attn``,
``cross_attn`` and ``ffn``, the norms, ``embed`` and ``lm_head``) are placed
by the same rules, the q heads of every sequence-mode attention (the
encoder's, the decoder's self and cross reads) split over "model" as a
decoder's prefill splits them.  Its caches (self, cross) place as the reference's
``launch/specs._cache_specs`` does: K/V [L, B, S, K, Dh] over (batch axes,
sequence axes) and the positions [L, S] over the sequence axes, an axis that
does not divide left whole.  A decode step reads the self cache through
``decode_attn_fn(B, cfg.decoder_cache_len)`` and the cross cache through
``cross_attn_fn(B, S_m)``: this rank's window of the source as partials,
combined over the sequence group.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import warnings

import torch

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels import kv_dequant, ops
from repro_torch.kernels.kv_dequant import kv_spec
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.tree import leaves, unflatten

_COL_MODULES = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "frame_proj", "router"}
_ROW_MODULES = {"wo", "w_down", "out_proj"}

#: the leaves of an attention cache that hold K/V (dense or packed k-bit):
#: [.., B, S_c, ...], so they sequence-shard alike
_KV_CACHE_KEYS = ("k", "v", "k_packed", "k_scales", "v_packed", "v_scales")
#: a QuantizedTensor's data fields (the leaves of its placement)
_QT_FIELDS = ("packed", "scales", "means", "codebook", "outlier_vals", "outlier_idx")

#: activation kinds and their placements, the reference's table ("dp" = the
#: data axes, "tp" = "model").  ``expert_hidden4``, ``ssd_intra`` and
#: ``ssd_bn`` are what the products of sliced inputs have (the port slices
#: the inputs, not them), and ``moe_groups`` is the reference's: the port
#: routes the whole tokens on every rank
_ACTIVATIONS = {
    "residual": ("dp", None, None),
    "heads": ("dp", None, "tp", None),
    "kv_heads": ("dp", None, None, None),
    "ffn_hidden": ("dp", None, "tp"),
    "logits": ("dp", None, "tp"),
    "moe_groups": ("dp", None, None),               # [G, Tg, D]
    "expert_buffer4": ("dp", "tp", None, None),     # [G, E, C, D]
    "expert_hidden4": ("dp", "tp", None, None),
    "ssm_heads": ("dp", None, "tp", None),          # [B, S, H, P]
    "ssm_dt": ("dp", None, "tp"),                   # [B, S, H]
    "ssm_bc": ("dp", None, None, None),             # [B, S, G, N]
    "ssd_intra": ("dp", None, None, None, "tp"),    # [B, n, Q, Q, H]
    "ssd_bn": ("dp", None, None, "tp", None),       # [B, n, Q, H, N]
}
#: the port's own kinds, for what it cuts that the reference leaves to GSPMD
_PORT_ACTIVATIONS = {
    "expert_counts": ("dp", "tp"),                  # [G, E], as expert_buffer4
    "ssm_conv": ("dp", None, "tp"),                 # [B, S, conv_dim], as conv_w
    "ssm_state": ("dp", "tp", None, None),          # [B, H, P, N], as the cache
    "ssm_vec": ("tp",),                             # [H] or [conv_dim] leaves
}


class SeqShardFallbackWarning(UserWarning):
    """A per-layer cache length does not divide the sequence-shard grid:
    that layer decodes over its whole (batch-split) cache with the local
    read instead of the sharded flash-decoding."""


def check_decode_capability(cfg, sharder, *, caller: str = "the serving entry point") -> None:
    """The one gate for a quantized cache on a mesh: a quantile KV codebook
    (``kv_spec``) and a feature row that cannot hold whole code words
    (``kv_layout``) raise, naming ``caller``; cache lengths that do not
    divide the grid are not errors (``decode_attn_fn`` falls back), and an
    arch without attention layers has no K/V row to check."""
    try:
        kvq = kv_spec(cfg)
    except ValueError as e:
        raise ValueError(f"{e} (rejected at setup for {caller})") from e
    if kvq is None or sharder is None:
        return
    if getattr(sharder, "mesh", None) is None or sharder.replicate:
        return
    if not any(m.startswith("attn") for m, _ in cfg.layer_schedule()):
        return   # no attention layer: no K/V row to lay out (mamba2)
    try:
        kv_dequant.kv_layout(kvq, cfg.n_kv_heads * cfg.head_dim)
    except ValueError as e:
        raise ValueError(f"kv_bits={cfg.kv_bits} cannot serve {caller} on a mesh: {e}") from e


def _maybe(axis, dim_size, axis_size):
    """``axis`` if it divides the dim, else None."""
    if axis is None:
        return None
    return axis if dim_size % axis_size == 0 else None


def _map(fn, tree, specs=None, keys=()):
    """``fn(keys, leaf, spec)`` over a tree of dicts, lists and tuples (a
    QuantizedTensor is a leaf); ``specs`` is a tree of the same shape, or
    None (spec None everywhere)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if specs is None else specs[k], keys + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, None if specs is None else specs[i], keys + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(list(keys), tree, specs)


class PlacedParams(dict):
    """A params tree cut to this rank's slices (``Sharder.shard_params``)."""


class _Constrain:
    """A sharder's activation placement: ``constrain(x, kind)`` is this
    rank's slice of a whole activation, ``constrain.gather(x, kind, shape)``
    the whole one (shape ``shape``) back from every rank's slice."""

    def __init__(self, sharder: "Sharder"):
        self.sharder = sharder

    def __call__(self, x, kind: str):
        s = self.sharder
        spec = s._act_spec(x.shape, kind)
        if spec is None:
            return x
        if kind == "heads" and x.shape[2] != s.head_pad():
            raise ValueError(f"q has {x.shape[2]} heads: pad them to head_pad() = "
                             f"{s.head_pad()} (q_pad) before splitting them")
        if s.batch_local and self._partial(spec, kind):
            # a part of a whole value: its gradient summed over "model"
            x = ops.fan_in(x, s.group(s.tp))
        x = s._slice(x, spec)
        return s._kv_heads_for_local_q(x) if kind == "kv_heads" else x

    def _partial(self, spec, kind: str) -> bool:
        """Whether this rank uses a part of a whole value of ``kind``: its
        slice over "model", the KV heads of its q heads, or B and C read by
        its SSD heads where those are split."""
        s = self.sharder
        if kind == "kv_heads":
            return True
        if kind == "ssm_bc":
            spec = s._act_spec((1, 1, s.cfg.n_ssm_heads, 1), "ssm_heads")
        return any(s.tp in ops.axis_names(a) for a in spec)

    def batch_sum(self, x):
        """A per-rank partial of a sum over the batch, summed over the data
        axes where the batch is split (a train step's), else x."""
        s = self.sharder
        if not s.batch_local or not s.dp_axes:
            return x
        return ops.all_reduce(x, s.group(s.dp_axes))

    def batch_share(self) -> tuple[int, int]:
        """(this rank's index, the number of ranks) over which the batch's
        rows are split: the data axes in a train step, else (0, 1)."""
        s = self.sharder
        if not s.batch_local or not s.dp_axes:
            return 0, 1
        return s.coord(s.dp_axes)

    def batch_whole(self, x):
        """Every data rank's rows of ``x`` (dim 0) in rank order, where the
        batch is split: one all-gather, whose adjoint (``ops.fsdp_gather``'s)
        sums the data ranks' gradients and keeps this rank's rows, since
        they differ between data ranks."""
        s = self.sharder
        if not s.batch_local or not s.dp_axes:
            return x
        return ops.fsdp_gather(x, 0, s.group(s.dp_axes))

    def gather(self, x, kind: str, shape):
        s = self.sharder
        spec = s._act_spec(shape, kind)
        if spec is None:
            return x
        for d, axes in enumerate(spec):
            if axes is not None:
                x = ops.gather_dim(x, d, s.group(axes))
        return x


class Sharder:
    def __init__(self, mesh, cfg, *, fsdp: bool = True,
                 replicate_params_below: int = 400_000_000):
        """``mesh``: a ``DeviceMesh`` (``launch/mesh.make_mesh``), None (no
        mesh), or any object with ``mesh_dim_names`` (or ``axis_names``) and
        ``shape`` (a tuple or a {name: size} dict) for the placements alone."""
        self.mesh = mesh
        self.cfg = cfg
        self.fsdp = fsdp
        self.constrain = _Constrain(self)
        self._groups: dict = {}
        self._coords: dict = {}
        # the train step's view (``training()``): the batch split over the
        # data axes already, dense leaves stored cut over "data"
        self.batch_local = False
        self.fsdp_storage = False
        self._train_placement = None
        if mesh is None:
            self.axis_names, self.axis_sizes = (), {}
            self.dp_axes = ()
            self.tp = None
            self.tp_size = 1
            self.dp_size = 1
            self.replicate = True
            self.fsdp_axis = None
            return
        names = tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)
        shape = mesh.shape
        self.axis_names = names
        self.axis_sizes = dict(shape) if isinstance(shape, dict) else dict(zip(names, shape))
        self.tp = "model"
        self.dp_axes = tuple(n for n in names if n != "model")
        self.tp_size = self.axis_sizes["model"]
        self.dp_size = math.prod(self.axis_sizes[n] for n in self.dp_axes)
        # small models: replicating weights beats TP overhead
        self.replicate = cfg.param_count() * 2 < replicate_params_below
        self.fsdp_axis = "data" if (fsdp and not self.replicate) else None
        if hasattr(mesh, "get_group"):
            self._init_groups()
        elif hasattr(mesh, "get_coordinate"):   # a stand-in: placements and slices only
            self._coords = dict(zip(names, mesh.get_coordinate()))

    # -- the world -----------------------------------------------------------
    def _init_groups(self) -> None:
        """A process group for every set of axes (one axis: the mesh's own;
        several: ``new_group``, made by every rank in the same order) and
        this rank's coordinate on each axis."""
        import torch.distributed as dist

        names, ranks = self.axis_names, self.mesh.mesh
        me = dist.get_rank()
        for r in range(1, len(names) + 1):
            for dims in itertools.combinations(range(len(names)), r):
                key = tuple(names[d] for d in dims)
                if r == 1:
                    self._groups[key] = self.mesh.get_group(key[0])
                    continue
                rest = [d for d in range(len(names)) if d not in dims]
                rows = ranks.permute(rest + list(dims)).reshape(
                    -1, math.prod(ranks.shape[d] for d in dims))
                for row in rows.tolist():
                    g = dist.new_group(row)
                    if me in row:
                        self._groups[key] = g
        self._coords = dict(zip(names, self.mesh.get_coordinate()))

    def _axes(self, axes) -> tuple:
        """Axes (a name, a tuple of them, or None) as a tuple in mesh order."""
        want = set(ops.axis_names(axes))
        return tuple(n for n in self.axis_names if n in want)

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        return self._groups[self._axes(axes)]

    def coord(self, axes) -> tuple[int, int]:
        """(this rank's linear index over ``axes`` in mesh order, their size);
        (0, 1) for no axes."""
        idx, size = 0, 1
        for a in self._axes(axes):
            idx = idx * self.axis_sizes[a] + self._coords[a]
            size *= self.axis_sizes[a]
        return idx, size

    def _slice(self, x: torch.Tensor, spec, axes=None) -> torch.Tensor:
        """This rank's slice of a whole ``x`` placed by ``spec``: each dim
        split over its entry's axes (only those in ``axes`` when given)."""
        for d, entry in enumerate(spec):
            if entry is None or (axes is not None and not set(ops.axis_names(entry)) & set(axes)):
                continue
            i, n = self.coord(entry)
            c = x.shape[d] // n
            x = x.narrow(d, i * c, c)
        return x

    # -- helpers ---------------------------------------------------------------
    def _ns(self, *spec) -> tuple:
        return tuple(spec)

    @property
    def dp(self):
        return self.dp_axes if self.dp_axes else None

    def _axis_size(self, a) -> int:
        if a is None:
            return 1
        if isinstance(a, tuple):
            return math.prod(self.axis_sizes[n] for n in a)
        return self.axis_sizes[a]

    def head_pad(self) -> int:
        """q-head count padded so heads are TP- and GQA-divisible."""
        cfg = self.cfg
        if not cfg.n_heads:
            return 0
        if self.mesh is None or self.replicate:
            return cfg.n_heads
        K = max(cfg.n_kv_heads, 1)
        h = cfg.n_heads
        while h % K or h % self.tp_size:
            h += 1
        return h

    # -- activations -----------------------------------------------------------
    def _act_spec(self, shape, kind: str):
        """The placement of an activation of ``shape`` and ``kind`` (axes
        that do not divide dropped), or None where it stays whole."""
        if self.mesh is None or self.replicate:
            return None
        spec = _ACTIVATIONS.get(kind) or _PORT_ACTIVATIONS.get(kind)
        if spec is None or len(spec) != len(shape):
            return None
        dp = None if self.batch_local else self.dp
        named = [dp if a == "dp" else self.tp if a == "tp" else None for a in spec]
        return tuple(_maybe(a, shape[i], self._axis_size(a)) for i, a in enumerate(named))

    def _kv_heads_for_local_q(self, k: torch.Tensor) -> torch.Tensor:
        """The KV heads [B, S, K', Dh] this rank's q heads read: a rank
        holds q heads [h0, h0 + Hl) of head_pad(), grouped G = head_pad() / K
        a KV head.  A whole number of groups, or heads within one group,
        is a slice; otherwise each q head gets its KV head (K' = Hl)."""
        Hp, K = self.head_pad(), k.shape[2]
        G, Hl = Hp // K, Hp // self.tp_size
        h0 = self.coord(self.tp)[0] * Hl
        if Hl % G == 0 and h0 % G == 0:
            return k.narrow(2, h0 // G, Hl // G)
        if G % Hl == 0:
            return k.narrow(2, h0 // G, 1)
        idx = torch.div(h0 + torch.arange(Hl, device=k.device), G, rounding_mode="floor")
        return k.index_select(2, idx)

    # -- parameter specs -------------------------------------------------------
    def param_spec_tree(self, params):
        """The placement of every leaf of a (possibly quantized) params tree:
        a tuple a tensor leaf, a QuantizedTensor of tuples for a quantized
        one; None everywhere without a mesh."""
        return _map(lambda keys, leaf, _: self._leaf_spec(keys, leaf), params)

    def _leaf_spec(self, keys, leaf):
        if isinstance(leaf, QuantizedTensor):
            return self._qt_spec(keys, leaf)
        if self.mesh is None:
            return None
        if self.replicate or leaf.ndim == 0:
            return self._ns()
        tp, fs = self.tp, self.fsdp_axis
        name = next((k for k in reversed(keys) if isinstance(k, str)), "")
        shape = leaf.shape
        if name in ("embed", "lm_head"):
            return self._ns(_maybe(tp, shape[0], self.tp_size),
                            _maybe(fs, shape[1], self._axis_size(fs)))
        if "ffn" in keys and name in ("w_gate", "w_up", "w_down") and leaf.ndim == 4:
            # an expert stack [n_p, E, In, Out]: experts over "model", FSDP on In
            return self._ns(None, _maybe(tp, shape[1], self.tp_size),
                            _maybe(fs, shape[2], self._axis_size(fs)), None)
        if name == "router":
            return self._ns()
        if name == "w" and leaf.ndim >= 2:
            owner = next((k for k in reversed(keys[:-1]) if isinstance(k, str)), "")
            lead = (None,) * (leaf.ndim - 2)
            i, o = shape[-2], shape[-1]
            if owner in _ROW_MODULES:
                return self._ns(*lead, _maybe(tp, i, self.tp_size),
                                _maybe(fs, o, self._axis_size(fs)))
            return self._ns(*lead, _maybe(fs, i, self._axis_size(fs)),
                            _maybe(tp, o, self.tp_size))
        if name == "b" and leaf.ndim >= 1:
            lead = (None,) * (leaf.ndim - 1)
            return self._ns(*lead, _maybe(tp, leaf.shape[-1], self.tp_size))
        if name == "conv_w" and leaf.ndim >= 2:
            lead = (None,) * (leaf.ndim - 2)
            return self._ns(*lead, None, _maybe(tp, leaf.shape[-1], self.tp_size))
        return self._ns()

    def _qt_spec(self, keys, qt: QuantizedTensor):
        """Quantized leaves: column-parallel on the output rows over "model".
        Row-structured storage splits its row dim (-2); flat storage its
        flat dim when it divides.  An expert stack (two batch dims [n_p, E])
        cuts every field on E instead, where E divides."""
        if self.mesh is None:
            return dataclasses.replace(qt, **{f: None for f in _QT_FIELDS})
        tp = None if self.replicate else self.tp
        nb = len(qt.batch_shape)

        def leaf_spec(a, shardable=True, structured_leaf=False):
            if a is None:
                return None
            lead = [None] * a.ndim
            if nb == 2:   # the expert branch comes before the shardable test
                if qt.batch_shape[-1] % self.tp_size == 0:
                    lead[nb - 1] = tp
                return self._ns(*lead)
            if shardable and tp is not None:
                out_rows = qt.quant_shape[0]
                if structured_leaf and a.ndim >= 2:
                    if out_rows % self.tp_size == 0:
                        lead[-2] = tp
                elif a.ndim >= 1:
                    if out_rows % self.tp_size == 0 and a.shape[-1] % self.tp_size == 0:
                        lead[-1] = tp
            return self._ns(*lead)

        st = qt.structured
        return dataclasses.replace(
            qt,
            packed=leaf_spec(qt.packed, structured_leaf=st),
            scales=leaf_spec(qt.scales, structured_leaf=st),
            means=leaf_spec(qt.means, structured_leaf=st),
            codebook=leaf_spec(qt.codebook, shardable=False),
            outlier_vals=leaf_spec(qt.outlier_vals, shardable=False),
            outlier_idx=leaf_spec(qt.outlier_idx, shardable=False),
        )

    def shard_params(self, params):
        """This rank's slices of a whole params tree (a ``PlacedParams``):
        each leaf split over "model" by its placement becomes a
        ``kernels/ops.Placed``; the rest stays as it is (FSDP's "data" too,
        module docstring).  A tree that is placed already comes back as it is."""
        if self.mesh is None or self.replicate or isinstance(params, PlacedParams):
            return params
        tp = self.tp

        def own(full, part):
            return part if part.numel() == full.numel() else part.contiguous().clone()

        def place(keys, leaf, spec):
            if isinstance(leaf, QuantizedTensor) and len(leaf.batch_shape) == 2:
                # an expert stack: every field cut on E (this rank's experts)
                ps = spec.packed
                if ps is None or tp not in ops.axis_names(ps[1]):
                    return leaf
                cut = {f: own(getattr(leaf, f), self._slice(getattr(leaf, f),
                                                            getattr(spec, f), axes=(tp,)))
                       for f in _QT_FIELDS if getattr(leaf, f) is not None}
                return ops.Placed(dataclasses.replace(leaf, **cut), ps, self)
            if isinstance(leaf, QuantizedTensor):
                ps = spec.packed
                if not leaf.structured or ps is None or tp not in ops.axis_names(ps[-2]):
                    return leaf
                i, n = self.coord(tp)
                c = leaf.quant_shape[0] // n
                cut = {f: own(getattr(leaf, f), getattr(leaf, f).narrow(-2, i * c, c))
                       for f in ("packed", "scales", "means") if getattr(leaf, f) is not None}
                local = dataclasses.replace(leaf, **cut,
                                            quant_shape=(c,) + tuple(leaf.quant_shape[1:]))
                return ops.Placed(local, ps, self)
            if not spec or not any(tp in ops.axis_names(a) for a in spec):
                return leaf
            return ops.Placed(own(leaf, self._slice(leaf, spec, axes=(tp,))), spec, self)

        return PlacedParams(_map(place, params, self.param_spec_tree(params)))

    # -- the train state (FSDP storage) ---------------------------------------
    def training(self) -> "Sharder":
        """The train step's view of this sharder (the same groups): the batch
        is split over the data axes for the whole step (activation
        placements drop them, products split no rows) and dense leaves are
        stored cut over "data" (``Placed.gathered``).  Without a mesh, self."""
        if self.mesh is None or self.batch_local:
            return self
        view = copy.copy(self)
        view.batch_local = view.fsdp_storage = True
        view.constrain = _Constrain(view)
        view._train_placement = None
        return view

    def train_placement(self) -> "TrainPlacement":
        """The FSDP placement of this config's train state (made once)."""
        if self._train_placement is None:
            self._train_placement = TrainPlacement(self)
        return self._train_placement

    def shard_train_state(self, state):
        """This rank's slices of a whole TrainState (params, AdamW moments,
        compression errors; ``TrainPlacement``)."""
        return self.train_placement().cut_state(state)

    def gather_train_state(self, state):
        """The whole TrainState back from every rank's slices (collective:
        every rank of the world calls it)."""
        return self.train_placement().gather_state(state)

    def cut(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This rank's slice of a whole leaf placed by ``spec``, its own
        storage where it is a part (the leaf itself where it is whole)."""
        part = self._slice(x, spec)
        return part if part.numel() == x.numel() else part.contiguous().clone()

    def whole(self, x: torch.Tensor, spec) -> torch.Tensor:
        """A leaf placed by ``spec`` put back together from every rank's
        slice (one all-gather a split dim; no gradient)."""
        with torch.no_grad():
            for d, entry in enumerate(spec or ()):
                if entry is not None:
                    x = ops.gather_dim(x, d, self.group(entry))
        return x

    def local_shape(self, shape, spec) -> tuple:
        """The shape of this rank's slice of a leaf of ``shape``."""
        spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
        return tuple(n if e is None else n // self._axis_size(e) for n, e in zip(shape, spec))

    # -- caches ----------------------------------------------------------------
    def decode_plan(self, batch: int):
        """(batch_axes, seq_axes) of the KV cache at this batch size."""
        if self.mesh is None:
            return None, None
        usable = []
        rem = batch
        for a in self.dp_axes:
            if rem % self.axis_sizes[a] == 0:
                usable.append(a)
                rem //= self.axis_sizes[a]
        batch_axes = tuple(usable) or None
        # seq gets "model" plus any dp axis not absorbed by the batch
        seq_axes = tuple(a for a in self.axis_names if a not in usable)
        return batch_axes, seq_axes

    def cache_spec_tree(self, caches, batch: int, *, paged: bool = False):
        """The placement of every leaf of a decode-cache tree.  ``paged``: a
        page-major pool (serving/pages.py), pages over the batch axes like
        slots and the intra-page token axis whole."""
        if self.mesh is None:
            return _map(lambda *_: None, caches)
        b_ax, s_ax = self.decode_plan(batch)
        tp = None if self.replicate else self.tp

        def spec(keys, leaf, _):
            if any(k in _KV_CACHE_KEYS for k in keys):
                # dense [n_p, B, S, K, Dh] or packed [n_p, B, S, X]: slots on dim 2
                if paged:
                    return self._ns(None, b_ax, None, *((None,) * (leaf.ndim - 3)))
                s = _maybe(s_ax, leaf.shape[2], self._axis_size(s_ax))
                return self._ns(None, b_ax, s, *((None,) * (leaf.ndim - 3)))
            if "pos" in keys:
                if leaf.ndim == 3:  # per-slot [n_p, B, S_c]
                    if paged:
                        return self._ns(None, b_ax, None)
                    s = _maybe(s_ax, leaf.shape[2], self._axis_size(s_ax))
                    return self._ns(None, b_ax, s)
                s = _maybe(s_ax, leaf.shape[1], self._axis_size(s_ax))
                return self._ns(None, s)
            if "state" in keys:   # [n_p, B, H, P, N]: heads over "model"
                return self._ns(None, b_ax, _maybe(tp, leaf.shape[2], self.tp_size), None, None)
            if "conv" in keys:    # [n_p, B, cw - 1, conv_dim]: channels over "model"
                return self._ns(None, b_ax, None, _maybe(tp, leaf.shape[3], self.tp_size))
            return self._ns()

        return _map(spec, caches)

    def shard_caches(self, caches, batch: int, *, paged: bool = False):
        """This rank's slices of a whole cache tree (placed by
        ``cache_spec_tree``), each its own storage."""
        if self.mesh is None or self.replicate:
            return caches

        def place(keys, leaf, spec):
            part = self._slice(leaf, spec)
            return part if part.numel() == leaf.numel() else part.contiguous().clone()

        return _map(place, caches, self.cache_spec_tree(caches, batch, paged=paged))

    def local_row(self, cc, slot: int, batch: int):
        """A whole batch-1 prefill cache ``cc`` for ``slot`` of a pool of
        ``batch`` rows, as this rank writes it: (its row in this rank's
        slice of the pool, ``cc`` cut to this rank's slot windows), or
        (None, None) where another rank holds the slot."""
        if self.mesh is None or self.replicate:
            return slot, cc
        b_ax, _ = self.decode_plan(batch)
        i, n = self.coord(b_ax)
        per = batch // n
        if not i * per <= slot < (i + 1) * per:
            return None, None

        def piece(keys, leaf, spec):
            if any(k in _KV_CACHE_KEYS + ("state", "conv") for k in keys):
                spec = (None, None) + tuple(spec[2:])   # cc's batch of one stays whole
            return self._slice(leaf, spec)

        return slot - i * per, _map(piece, cc, self.cache_spec_tree(cc, batch))

    def whole_row(self, caches, slot: int, batch: int):
        """Row ``slot`` of a pool of ``batch`` rows placed by ``shard_caches``,
        whole and as stored, on every rank (collective: every rank calls it
        for the same slot, in the same order): each leaf's row [n_p, ...]
        with its sequence windows, KV heads, SSM state heads and conv
        channels gathered from the ranks that hold them.  A rank of another
        data coordinate sends a row it holds and the slot owner's is kept,
        so the row can be written back into a slot of any data rank
        (``local_row``).  Without a mesh, views of the pool's rows."""
        if self.mesh is None or self.replicate:
            return _map(lambda keys, leaf, _: leaf[:, slot], caches)
        b_ax, _ = self.decode_plan(batch)
        i, n = self.coord(b_ax)
        owner, j = divmod(slot, batch // n)
        mine = j if i == owner else 0

        def row(keys, leaf, spec):
            return self.whole(leaf[:, mine:mine + 1], spec)[:, owner]

        return _map(row, caches, self.cache_spec_tree(caches, batch))

    # -- sharded decode attention ----------------------------------------------
    def pad_cache_len(self, cache_len: int) -> int:
        """A cache budget rounded UP to a multiple of the mesh size, so full
        attention caches divide any sequence-shard grid the batch split can
        give."""
        if self.mesh is None or self.replicate:
            return cache_len
        n = math.prod(self.axis_sizes.values())
        return -(-cache_len // n) * n

    def seq_shard_plan(self, batch: int, cache_len: int) -> dict[int, bool]:
        """Every per-layer cache length this config decodes with (a ring
        caps its at the window) -> whether it divides the sequence-shard
        grid; False entries decode with the local fallback."""
        if self.mesh is None or self.replicate:
            return {}
        _, s_ax = self.decode_plan(batch)
        s_size = self._axis_size(s_ax)
        plan: dict[int, bool] = {}
        for mixer, _ in self.cfg.layer_schedule():
            if not mixer.startswith("attn"):
                continue
            w = blocks.mixer_window(mixer, self.cfg)
            eff = min(cache_len, w) if w else cache_len
            plan[eff] = eff % s_size == 0
        return plan

    def _warn_fallback(self, lengths, s_size) -> None:
        warnings.warn(
            f"cache length(s) {sorted(lengths)} do not divide the {s_size}-way "
            "sequence-shard grid: those layers fall back to the local decode read over "
            "their whole cache. Pad the cache budget / window to a multiple of the "
            "seq shards to keep them sharded.",
            SeqShardFallbackWarning, stacklevel=3)

    def decode_attn_fn(self, batch: int, cache_len: int | None = None):
        """A ``decode_attn`` (``blocks.apply_layer_decode``'s hook) for a
        decode batch of ``batch`` rows over caches of ``cache_len`` placed by
        ``shard_caches``: ``blocks.local_decode_attn`` without a mesh or when
        replicating, else the sequence-sharded read (module docstring), for
        dense or packed caches, shared or per-slot positions.  The rows of
        the batch split over the data axes it fills and are gathered after.
        Lengths that do not divide the grid warn here and at their first
        read, and take the local read."""
        if self.mesh is None or self.replicate:
            return blocks.local_decode_attn
        if cache_len is None:
            raise ValueError("a sharded decode needs the cache length its caches were "
                             "placed with (decode_attn_fn(batch, cache_len))")
        b_ax, s_ax = self.decode_plan(batch)
        s_size = self._axis_size(s_ax)
        plan = self.seq_shard_plan(batch, cache_len)
        bad = [L for L, ok in plan.items() if not ok]
        if bad:
            self._warn_fallback(bad, s_size)
        warned: set = set()
        b_idx, b_n = self.coord(b_ax)
        rows = slice(b_idx * (batch // b_n), (b_idx + 1) * (batch // b_n))
        seq = self.group(s_ax)
        offset_of = self.coord(s_ax)[0]

        def fn(q, k_new, v_new, cache, pos, *, cap=0.0, window=0, kvq=None):
            S_total = min(cache_len, window) if window else cache_len
            kvq = kvq if "k_packed" in cache else None
            q, k_new, v_new = q[rows], k_new[rows], v_new[rows]
            pos = pos[rows] if pos.ndim else pos
            if S_total % s_size == 0:
                o = self._sharded_decode(q, k_new, v_new, cache, pos, cap=cap, window=window,
                                         kvq=kvq, S_total=S_total,
                                         offset=offset_of * (S_total // s_size), group=seq)
            else:
                if S_total not in warned:
                    warned.add(S_total)
                    self._warn_fallback([S_total], s_size)
                o = blocks.local_decode_attn(q, k_new, v_new, cache, pos, cap=cap,
                                             window=window, kvq=kvq)
            return o if b_ax is None else ops.gather_dim(o, 0, self.group(b_ax))

        return fn

    def cross_attn_fn(self, batch: int, source_len: int):
        """The cross read of an encoder-decoder's decode step
        (``seq2seq.decode_step(cross_attn=)``) for ``batch`` rows over a
        cross cache of ``source_len`` source positions placed by
        ``shard_caches``: ``fn(q [B, H, Dh], one layer's {"k", "v", "pos"})``
        -> [B, H, Dh], every source position valid.  Without a mesh or when
        replicating, the plain read over the whole source.  On a mesh this
        rank's rows of q over its window of the source, read as
        flash-decoding partials and combined over the sequence group as the
        self read combines them (``attention.combine_partials``: one MAX, one
        SUM), the rows gathered over the data axes after.  A source length
        that does not divide the grid warns here and at its first read, and
        reads this rank's rows over the whole (unsplit) source."""
        every = source_len + 1   # past the last source position
        if self.mesh is None or self.replicate:
            return lambda q, cache: attn_mod.decode_attention(q, cache, every)
        b_ax, s_ax = self.decode_plan(batch)
        s_size = self._axis_size(s_ax)
        split = source_len % s_size == 0
        if not split:
            self._warn_fallback([source_len], s_size)
        warned: list = []
        b_idx, b_n = self.coord(b_ax)
        rows = slice(b_idx * (batch // b_n), (b_idx + 1) * (batch // b_n))
        seq = self.group(s_ax)

        def fn(q, cache):
            q = q[rows]
            if split:
                B, H, Dh = q.shape
                m, l, pv = attn_mod.decode_attention_partial(q, cache["k"], cache["v"],
                                                             cache["pos"], every)
                o = attn_mod.combine_partials(m, l, pv, group=seq).reshape(B, H, Dh)
                o = o.to(q.dtype)
            else:
                if not warned:
                    warned.append(source_len)
                    self._warn_fallback([source_len], s_size)
                o = attn_mod.decode_attention(q, cache, every)
            return o if b_ax is None else ops.gather_dim(o, 0, self.group(b_ax))

        return fn

    def _sharded_decode(self, q, k_new, v_new, cache, pos, *, cap, window, kvq, S_total,
                        offset, group):
        """One rank's step of the sequence-sharded read: the token written
        where this rank owns its slot, the window (dequantized when packed)
        read into partials, the partials combined over the sequence group."""
        attn_mod.write_cache_local_window(cache, k_new, v_new, pos, S_total=S_total,
                                          offset=offset, window=window, kvq=kvq)
        B, H, Dh = q.shape
        S_loc = cache["pos"].shape[-1]
        if kvq is not None:
            K = k_new.shape[-2]
            k, v = (t.reshape(B, S_loc, K, Dh)
                    for t in kv_dequant.dequant_kv(cache, kvq, K * Dh))
        else:
            k, v = cache["k"], cache["v"]
        m, l, pv = attn_mod.decode_attention_partial(q, k, v, cache["pos"], pos, cap=cap,
                                                     window=window)
        return attn_mod.combine_partials(m, l, pv, group=group).reshape(B, H, Dh).to(q.dtype)


def no_sharder(cfg):
    return Sharder(None, cfg)


def spec_leaves(tree, specs) -> list:
    """The specs of ``tree``'s leaves (``specs``: a tree of its structure
    whose leaves are spec tuples) in ``tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in spec_leaves(v, specs[i])]
    return [] if tree is None else [specs]


class TrainPlacement:
    """Where a rank keeps its part of a train state on a mesh (FSDP
    storage; module docstring): dense, MoE (an expert stack cut on E and
    In), SSM and encoder-decoder trees alike.  ``specs`` is the reference's
    placement (``param_spec_tree``) of each leaf of the params tree, in
    ``tree.leaves`` order; the AdamW moments and the compression errors
    have the params' structure and take the same.  The state's step is
    whole everywhere.  Without a mesh every method hands its tree back."""

    def __init__(self, sharder: Sharder):
        from repro_torch.models import lm, seq2seq

        self.sharder = sharder.training()
        s = self.sharder
        init = seq2seq.init_params if s.cfg.encoder_decoder else lm.init_params
        self.template = init(s.cfg, device="meta")
        self.specs = spec_leaves(self.template, s.param_spec_tree(self.template))
        self.shapes = [tuple(t.shape) for t in leaves(self.template)]
        self.local_shapes = [s.local_shape(n, sp) for n, sp in zip(self.shapes, self.specs)]

    @property
    def on(self) -> bool:
        return self.sharder.mesh is not None and not self.sharder.replicate

    # -- trees of the params' structure ---------------------------------------
    def cut_tree(self, tree):
        if not self.on or tree is None:
            return tree
        return unflatten(tree, [self.sharder.cut(x, sp)
                                for x, sp in zip(leaves(tree), self.specs, strict=True)])

    def gather_tree(self, tree):
        if not self.on or tree is None:
            return tree
        return unflatten(tree, [self.sharder.whole(x, sp)
                                for x, sp in zip(leaves(tree), self.specs, strict=True)])

    def live(self, flat: list):
        """The params tree for the loss from this rank's leaves (``flat``, in
        leaves order): a leaf split over any axis as a ``kernels/ops.Placed``
        holding the train view, the rest as they are."""
        s = self.sharder
        if not self.on:
            return unflatten(self.template, flat)
        return unflatten(self.template, [
            ops.Placed(x, sp, s) if any(e is not None for e in sp) else x
            for x, sp in zip(flat, self.specs, strict=True)])

    def reduce_grads(self, flat: list) -> list:
        """Each leaf's gradient summed in place over the data axes its
        storage is not cut over (the reduce-scatter of its gather summed the
        rest)."""
        s = self.sharder
        if s.mesh is None or not s.dp_axes:
            return flat
        by_axes: dict = {}
        for i, sp in enumerate(self.specs):
            named = {n for e in (sp if self.on else ()) for n in ops.axis_names(e)}
            axes = tuple(a for a in s.dp_axes if a not in named)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            group = s.group(axes)
            for i in idx:
                ops.all_reduce(flat[i], group)
        return flat

    def shard_sums(self, sums: list) -> list:
        """Per-leaf sums over this rank's slices (a 0-d tensor each, leaves
        order) as sums over the whole leaves: each all-reduced over the axes
        its leaf is split over, one all-reduce a set of axes; a leaf stored
        whole is counted once."""
        if not self.on:
            return sums
        s, out = self.sharder, list(sums)
        by_axes: dict = {}
        for i, sp in enumerate(self.specs):
            axes = s._axes(tuple(n for e in sp for n in ops.axis_names(e)))
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            stacked = ops.all_reduce(torch.stack([out[i] for i in idx]), s.group(axes))
            for j, i in enumerate(idx):
                out[i] = stacked[j]
        return out

    # -- TrainStates ----------------------------------------------------------
    def map_state(self, state, fn):
        """``fn`` over a TrainState's params, moments and errors (trees of the
        params' structure); the step as it is."""
        return state._replace(params=fn(state.params),
                              opt=state.opt._replace(m=fn(state.opt.m), v=fn(state.opt.v)),
                              err=fn(state.err))

    def cut_state(self, state):
        """This rank's slices of a whole TrainState; one already cut (its
        leaves of the local shapes) comes back as it is."""
        if not self.on or self.is_local(state.params):
            return state
        return self.map_state(state, self.cut_tree)

    def gather_state(self, state):
        """The whole TrainState from every rank's slices (collective)."""
        return self.map_state(state, self.gather_tree)

    def is_local(self, params) -> bool:
        """Whether ``params`` holds this rank's slices; raises on shapes that
        are neither the slices nor the whole leaves."""
        got = [tuple(x.shape) for x in leaves(params)]
        if got == self.local_shapes:
            return True
        if got == self.shapes:
            return False
        raise ValueError(f"{self.sharder.cfg.name}: a params tree of neither this rank's "
                         "slices nor the whole leaves")
