"""Where the port's entry points run (no counterpart in ``repro``, which
leaves placement to jax's default backend).

The port runs on CUDA unless the caller asks for another device.  With the
default device and no CUDA it raises instead of carrying on quietly on the
CPU: a CPU run of the port is something a caller (a test) asks for.
"""

from __future__ import annotations

import torch

# H100 SXM data-sheet rates: dense bf16 tensor-core FLOP/s and HBM bytes/s —
# the step profiler's default peaks (serving/profiler.py), the counterparts
# of repro/launch/mesh.py's TPU v5e PEAK_FLOPS_BF16 and HBM_BW
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# the collective term's rate, the counterpart of the reference's ICI_BW
# ("per-chip injection, 1 link"): a 256- or 512-card mesh spans nodes of 8
# (a 16-way "model" axis two of them), so a card injects into the network
# through its one 400 Gb/s NDR port (ConnectX-7, one a GPU as a DGX H100
# wires them): 50e9 bytes/s.  A mesh inside one node would have NVLink 4's
# 450e9 bytes/s a direction instead.
NET_BW = 50e9


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None; raises when CUDA
    is asked for (explicitly or by default) and not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
