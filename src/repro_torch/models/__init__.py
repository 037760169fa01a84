"""Model code — port of the dense path of ``repro/models``: layers,
attention with the k-bit KV cache, blocks, the LM and post-training
quantization of its parameter tree."""
