"""The kernels' launch counters, read and moved together.

Each kernel wrapper counts its launches in a plain int on itself
(``<wrapper>.launches``, and ``qmatmul_gemm.simt_launches``);
``qmatmul_gemv_experts``, the expert-batched GEMV, counts apart from
``qmatmul_gemv``.  A CUDA graph
launches the kernels it recorded without calling the wrappers, so
``serving.engine.capture_graph`` takes the counts that its recording pass
added (``snapshot`` before and after), takes them back, since recording
launches nothing, and adds them at each replay (``add``): the counters then
count the launches on the card, eager or replayed.
"""

from __future__ import annotations


def _counters() -> tuple:
    from repro_torch.kernels import kv_attention, kv_dequant, qmatmul, quantize

    return ((qmatmul.qmatmul_gemv, "launches"), (qmatmul.qmatmul_gemv_tc, "launches"),
            (qmatmul.qmatmul_gemv_simt, "launches"), (qmatmul.qmatmul_gemm, "launches"),
            (qmatmul.qmatmul_gemm, "simt_launches"), (kv_dequant.dequant_kv_cuda, "launches"),
            (kv_attention.decode_attention_packed_cuda, "launches"),
            (quantize.quantize_blocks_cuda, "launches"),
            (quantize.quantize_pack_cuda, "launches"),
            (qmatmul.qmatmul_gemv_experts, "launches"))


def names() -> tuple[str, ...]:
    """Every counter's name, ``<wrapper>.<attribute>``, in ``snapshot``'s
    order."""
    return tuple(f"{fn.__name__}.{attr}" for fn, attr in _counters())


def snapshot() -> tuple[int, ...]:
    """Every counter's value, in a fixed order."""
    return tuple(getattr(fn, attr) for fn, attr in _counters())


def add(delta) -> None:
    """Add ``delta`` (one int a counter, in ``snapshot``'s order)."""
    for (fn, attr), d in zip(_counters(), delta):
        setattr(fn, attr, getattr(fn, attr) + d)
