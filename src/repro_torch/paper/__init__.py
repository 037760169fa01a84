"""The paper's experiments on the port — port of the paper-figure modules of
``benchmarks/`` (``common``, ``fig2_bitlevel``, ``fig3_datatypes``,
``fig3_blocksize``, ``fig4_proxy``, ``appb_centering``, ``table1_gptq``,
``kernel_bench``, ``run``).  They live inside the package so that they do
not collide with a benchmark folder of the port."""
