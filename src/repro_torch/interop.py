"""Carry the JAX package's arrays and parameter trees into the port (no
counterpart in ``repro``).

Takes numpy only — the caller turns jax arrays into numpy — so the port
stays free of jax:

* bf16 arrays go through a 16-bit integer view, because ``torch.from_numpy``
  rejects ml_dtypes' bfloat16;
* uint32 packed words become int32 views (``core/packing.py`` says why);
* a reference ``QuantizedTensor`` (recognized by its fields, without
  importing ``repro``) becomes the port's ``QuantizedTensor``.

``flatten`` names a port tree's leaves the way ``jax.tree_util.keystr``
names the reference tree's (``['stack'][0]['mixer']['wq']['w'].packed``), as
``repro/checkpoint/manager.py`` writes them, so trees compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qtensor import DATA_FIELDS, QuantizedTensor
from repro_torch.device import resolve_device

_META_FIELDS = ("quant_shape", "bits", "block_size", "dtype_name", "centering",
                "outlier_axis", "transposed", "structured", "orig_dtype")


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One reference array (numpy, or anything ``np.asarray`` takes) as a
    torch tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32).copy())
    else:
        t = torch.from_numpy(a.copy())
    return t.to(resolve_device(device))


def _is_reference_qtensor(node) -> bool:
    return all(hasattr(node, f) for f in DATA_FIELDS + _META_FIELDS)


def params_from_reference(tree, device=None):
    """A raw or already quantized reference tree (dicts, lists, arrays and
    QuantizedTensors) as the port's tree, with the same keys and the same
    bits in every leaf."""
    dev = resolve_device(device)

    def convert(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        if _is_reference_qtensor(node):
            data = {f: convert(getattr(node, f)) for f in DATA_FIELDS}
            meta = {f: getattr(node, f) for f in _META_FIELDS}
            meta["quant_shape"] = tuple(meta["quant_shape"])
            return QuantizedTensor(**data, **meta)
        return tensor_from_numpy(node, dev)

    return convert(tree)


def flatten(tree, prefix: str = "") -> dict:
    """{keystr path: tensor} over a port tree, in jax's key format."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}[{i}]"))
    elif isinstance(tree, QuantizedTensor):
        for f in DATA_FIELDS:
            if getattr(tree, f) is not None:
                out[f"{prefix}.{f}"] = getattr(tree, f)
    else:
        out[prefix] = tree
    return out
