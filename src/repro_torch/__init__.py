"""PyTorch/CUDA port of the k-bit inference scaling-laws system (``repro``).

The package mirrors ``repro``'s module layout and names: each module's
docstring names its counterpart there.  It imports torch, numpy and the
standard library only — never jax and nothing of ``repro`` — so it runs
on a machine that has neither.  Weight encodes, quantized weight matmuls
and packed KV-cache reads go through CUDA kernels written for Hopper
(``csrc/*.cu``, built at first use by ``kernels/_build.py``); on CPU
tensors the same wrappers run their plain PyTorch versions.

Entry points (``init_params``, ``quantize_params``, ``Engine``,
``train.loop.train``, ``python -m repro_torch.paper.run``, ...) run on
``cuda`` unless the caller passes ``device="cpu"``; with the default
device and no CUDA they raise (``repro_torch.device.resolve_device``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
