"""Post-training quantization of a parameter tree (the paper's zero-shot
setting) — port of ``repro/models/quantize.py`` without mixed-precision
plans.

Every parameter matrix becomes a k-bit QuantizedTensor: attention
projections, the MLP, the MoE expert stacks and lm_head.  Vectors (norms,
biases) and the MoE router stay 16-bit, and so does the embedding by
default.  Weights [..., In, Out] are stored
TRANSPOSED ([..., Out, In], ``quantize.py:52-66``) so blocks run along the
reduction dim, the fused dequant-GEMM's operand layout; lm_head [V, D] is
already (out, in).  Each matrix is encoded from the weight as stored, with
no transposed copy, by ``kernels/quantize.quantize_pack`` (one launch an
item on the card); centered matrices (App. B) go through
``core/blockwise.encode`` and the flat encode kernel instead.  An expert
stack [n_periods, E, In, Out] ("moe" units) becomes a transposed QT with two
batch dims, encoded an expert at a time (one launch each), each into its
place in the stack's storage: no f32 or transposed copy of a stack is made,
and a layer's or an expert's QT is a view (``QuantizedTensor.select``).

Proxy quantization (§3, Eq. 2): producer-weight std picks the outlier input
dims kept in 16-bit.  Within-block producers are exact (w_down <- w_up, wo
<- wv with GQA group tiling, an expert's w_down <- its w_up); residual-stream
consumers share one model-wide outlier set from the mean producer std across
layers, as in the reference.

Mixed precision: ``quantize_tree(..., plan=)`` takes a
``precision.PrecisionPlan`` that overrides bits/dtype/block_size/centering
a unit by name, ``bits >= 16`` keeping that matrix dense; ``quantizable_units``
is the planner's universe, the same walk without quantizing.

``bits_report`` is the paper's x-axis, total model bits.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.blockwise import mean_xla
from repro_torch.core.proxy import outlier_indices_topk, std_xla
from repro_torch.core.qtensor import QuantizedTensor, dequantize_tensor, quantize_tensor
from repro_torch.device import resolve_device
from repro_torch.tree import leaves, tree_map

#: module names whose {"w": ...} consumes the residual stream [D -> *]
_RESIDUAL_CONSUMERS = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "frame_proj"}


def _n_outliers(dim: int, pct: float) -> int:
    return max(1, int(round(dim * pct))) if pct > 0 else 0


def _quantize_matrix(w: torch.Tensor, qcfg: QuantConfig, outlier_idx=None) -> QuantizedTensor:
    """w [..., In, Out] -> QT storing [..., Out, In], blocks along In; each
    item is encoded from w as stored, without a transposed copy."""
    wt = torch.swapaxes(w, -1, -2)
    return quantize_tensor(
        wt, bits=qcfg.bits, dtype=qcfg.dtype, block_size=qcfg.block_size,
        batch_dims=wt.ndim - 2, centering=qcfg.centering, exponent_bits=qcfg.exponent_bits,
        outlier_idx=outlier_idx, outlier_axis=-1, transposed=True,
    )


def _producer_std(w: torch.Tensor) -> torch.Tensor:
    """std over the input dim for each output unit; w [..., In, Out] -> [..., Out]."""
    return std_xla(w, -2)


def _bc(idx, batch_shape):
    if idx is None:
        return None
    return idx.expand(tuple(batch_shape) + idx.shape[-1:])


def _paths(tree, keys=()):
    """(keys, leaf) over a tree in jax's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], keys + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, keys + (i,))
    elif tree is not None:
        yield keys, tree


def residual_outliers(params: dict, cfg, pct: float):
    """Model-wide outlier dims of the residual stream -> [n_out] or None."""
    if pct <= 0:
        return None
    stds = []
    for keys, leaf in _paths(params):
        if "w" in keys and any(k in ("w_down", "wo", "out_proj") for k in keys):
            if isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 \
                    and leaf.shape[-1] == cfg.d_model:
                stds.append(mean_xla(_producer_std(leaf).reshape(-1, cfg.d_model), 0))
    if not stds:
        return None
    mean_std = mean_xla(torch.stack(stds), 0)
    return outlier_indices_topk(mean_std, _n_outliers(cfg.d_model, pct))


def _module_outliers(name: str, w: torch.Tensor, container: dict, cfg, qcfg, j_res):
    """Outlier input-dim indices for a dense module's weight (or None)."""
    batch_shape = w.shape[:-2]
    if name in _RESIDUAL_CONSUMERS and w.shape[-2] == cfg.d_model:
        return _bc(j_res, batch_shape)
    if name == "w_down" and "w_up" in container:
        std = _producer_std(container["w_up"]["w"])  # [..., F]
        return outlier_indices_topk(std, _n_outliers(w.shape[-2], qcfg.outlier_pct))
    if name == "wo" and "wv" in container:
        std = _producer_std(container["wv"]["w"])  # [..., K*Dh]
        if cfg.n_heads and cfg.n_kv_heads and cfg.n_heads != cfg.n_kv_heads:
            g = cfg.n_heads // cfg.n_kv_heads
            std = torch.repeat_interleave(
                std.reshape(batch_shape + (cfg.n_kv_heads, cfg.head_dim)), g, dim=-2
            ).reshape(batch_shape + (cfg.n_heads * cfg.head_dim,))
        # map producer unit j to consumer input dim j (identity layout)
        return outlier_indices_topk(std, _n_outliers(w.shape[-2], qcfg.outlier_pct))
    if name == "lm_head" and w.shape[-2] == cfg.d_model:
        return _bc(j_res, batch_shape)
    return None


def _unit_outliers(kind, name, w, container, cfg, qcfg, j_res):
    """Proxy-quantization outlier indices for one unit (or None)."""
    if qcfg.outlier_pct <= 0:
        return None
    module = name.rsplit("/", 1)[-1]
    if kind == "matrix":
        return _module_outliers(module, w, container, cfg, qcfg, j_res)
    if kind == "moe":
        if module == "w_down" and "w_up" in container:
            std = _producer_std(container["w_up"])   # [n_p, E, F]
            return outlier_indices_topk(std, _n_outliers(w.shape[-2], qcfg.outlier_pct))
        if j_res is not None and w.shape[-2] == cfg.d_model:
            return _bc(j_res, w.shape[:2])
        return None
    if kind == "lm_head":
        return j_res[None] if j_res is not None else None
    return None  # embed: input dim is the vocab, no residual outliers


def quantize_unit(kind: str, w: torch.Tensor, qcfg: QuantConfig,
                  outlier_idx=None) -> QuantizedTensor:
    """kind "matrix" and "moe": [..., In, Out] -> transposed QT;
    "lm_head"/"embed": [V, D] is already (out, in)."""
    if kind in ("matrix", "moe"):
        return _quantize_matrix(w, qcfg, outlier_idx=outlier_idx)
    return quantize_tensor(
        w, bits=qcfg.bits, dtype=qcfg.dtype, block_size=qcfg.block_size,
        centering=qcfg.centering, exponent_bits=qcfg.exponent_bits,
        outlier_idx=outlier_idx, outlier_axis=-1,
    )


def _walk_units(params, base: QuantConfig, visit):
    """Recurse ``params``, calling ``visit(name, kind, w, container)`` on
    every quantizable unit, which returns the replacement weight; other
    leaves stay as they are.  ``name`` is the stable slash-joined tree
    path ("stack/0/mixer/wq"), ``kind`` one of "matrix", "moe" (an expert
    stack [n_periods, E, In, Out]), "lm_head", "embed"; ``base`` gates the
    lm_head and embedding switches."""

    def walk(tree, path):
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        if not isinstance(tree, dict):
            return tree
        out = {}
        for name, val in tree.items():
            unit = "/".join(path + (name,))
            # dense module {"w": matrix, ("b": bias)}
            if isinstance(val, dict) and isinstance(val.get("w"), torch.Tensor) \
                    and val["w"].ndim >= 2:
                out[name] = {k: (visit(unit, "matrix", v, tree) if k == "w"
                                 else walk(v, path + (name, k))) for k, v in val.items()}
            elif name in ("w_gate", "w_up", "w_down") and isinstance(val, torch.Tensor) \
                    and val.ndim == 4:
                out[name] = visit(unit, "moe", val, tree)
            elif name == "lm_head" and base.quantize_lm_head and isinstance(val, torch.Tensor):
                out[name] = visit(unit, "lm_head", val, tree)
            elif name == "embed" and base.quantize_embedding and isinstance(val, torch.Tensor):
                out[name] = visit(unit, "embed", val, tree)
            else:
                out[name] = walk(val, path + (name,))
        return out

    return walk(params, ())


def quantize_tree(params, cfg, *, qcfg: QuantConfig | None = None, plan=None, device=None):
    """Params tree -> the same tree with weight matrices quantized on
    ``device`` (CUDA by default).

    ``qcfg`` quantizes every unit uniformly; a ``plan``
    (precision/plan.py) overrides bits/dtype/block_size/centering per unit
    name, with bits >= 16 leaving that matrix dense.  Residual-stream
    outlier sets (proxy quantization) are computed once from the BASE
    config's outlier_pct and shared by all units, as in the uniform path."""
    if plan is None and qcfg is None:
        raise ValueError("quantize_tree needs qcfg and/or plan")
    base = qcfg if qcfg is not None else plan.default_config()
    if plan is not None and plan.arch and plan.arch != cfg.name:
        raise ValueError(
            f"plan was built for arch {plan.arch!r}, not {cfg.name!r} "
            "(rebuild with precision.build_plan, or clear plan.arch)"
        )
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, params)
    j_res = residual_outliers(params, cfg, base.outlier_pct)
    visited: set = set()

    def visit(name, kind, w, container):
        visited.add(name)
        ucfg = base if plan is None else plan.config_for(name, base)
        if ucfg.bits >= 16:
            return w  # plan keeps this matrix dense 16-bit
        oidx = _unit_outliers(kind, name, w, container, cfg, ucfg, j_res)
        return quantize_unit(kind, w, ucfg, outlier_idx=oidx)

    out = _walk_units(params, base, visit)
    if plan is not None:
        unknown = sorted(set(plan.assignments) - visited)
        if unknown:
            raise ValueError(
                f"plan assigns units not present in this tree: {unknown} "
                f"(known units: {sorted(visited)}); a typo'd or stale plan "
                "would otherwise silently fall back to the default bits"
            )
    return out


def quantize_params(params, qcfg: QuantConfig, cfg, *, device=None):
    """Uniform quantization of a params tree (the paper's setting)."""
    return quantize_tree(params, cfg, qcfg=qcfg, device=device)


def quantizable_units(params, cfg, qcfg: QuantConfig | None = None) -> dict:
    """Enumerate the tree's quantizable units WITHOUT quantizing:
    {name: {"kind", "w", "n_params", "shape", "outlier_idx"}} — the
    planning universe of precision/profile.py, which agrees with
    quantize_tree because both run the same walk.  "outlier_idx" is the
    proxy-quantization index set the quantizer would use under ``qcfg``
    (None when outlier_pct == 0), so sensitivity profiling measures the
    exact storage layout that serves.  Weights stay where they are."""
    base = qcfg if qcfg is not None else QuantConfig()
    j_res = residual_outliers(params, cfg, base.outlier_pct)
    units: dict = {}

    def visit(name, kind, w, container):
        units[name] = {
            "kind": kind,
            "w": w,
            "n_params": int(w.numel()),
            "shape": tuple(w.shape),
            "outlier_idx": _unit_outliers(kind, name, w, container, cfg, base, j_res),
        }
        return w

    _walk_units(params, base, visit)
    return units


def dequantize_params(qparams):
    """A quantized tree back to dense weights in each leaf's original dtype;
    transposed matrices go back to [In, Out]."""

    def one(leaf):
        if isinstance(leaf, QuantizedTensor):
            w = dequantize_tensor(leaf, out_dtype=getattr(torch, leaf.orig_dtype))
            return torch.swapaxes(w, -1, -2) if leaf.transposed else w
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(one(v) for v in leaf)
        return leaf

    return one(qparams)


def bits_report(qparams) -> dict:
    """Total-model-bits accounting over a quantized tree (paper's x-axis)."""
    q_bits = q_stored = 0.0
    q_params = fp_params = 0
    for leaf in leaves(qparams):
        if isinstance(leaf, QuantizedTensor):
            bd = leaf.bits_breakdown()
            q_bits += bd.ideal_bits_per_param * leaf.n_params
            q_stored += bd.stored_bits_per_param * leaf.n_params
            q_params += leaf.n_params
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            fp_params += leaf.numel()
    total = q_bits + 16.0 * fp_params
    n = max(q_params + fp_params, 1)
    return {
        "quantized_params": q_params,
        "fp16_params": fp_params,
        "total_bits_ideal": total,
        "total_bits_stored": q_stored + 16.0 * fp_params,
        "avg_bits_per_param": total / n,
    }
