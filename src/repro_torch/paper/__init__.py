"""The paper's experiments on the port — port of the paper-figure modules of
``benchmarks/`` (``common``, ``fig2_bitlevel``, ``fig3_datatypes``,
``fig3_blocksize``, ``run``).  They live inside the package so that they do
not collide with a benchmark folder of the port."""
