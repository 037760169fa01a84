"""The four example drivers — ports of the reference's ``examples/``, run
as ``python -m repro_torch.examples.<name>`` (on CUDA unless ``--device``
says otherwise):

* ``quickstart`` — blockwise quantization at several widths and data
  types, and the fused dequant-matmul;
* ``serve_quantized`` — train a small LM, quantize it and serve it through
  the Engine beside the 16-bit baseline;
* ``train_tiny_lm`` — training with checkpoints, a resume and gradient
  compression;
* ``scaling_laws`` — a miniature bit-level scaling law (the paper's Fig. 2).

Each has a ``main(argv)``; the flags that size the work (``--steps``,
``--batch``, ...) default to the reference's values.
"""
