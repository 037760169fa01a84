"""The paper's experiments on the port — port of ``benchmarks/run.py`` for the
suites of the port.

    PYTHONPATH=src python -m repro_torch.paper.run
        [--only fig2,fig3dt,fig3bs,fig4,appb,table1,kernel,roofline,serve,figmix,plan,ledger]
        [--device cpu] [--sizes tiny-160k,tiny-650k] [--steps N]
        [--cache-dir DIR]

Trains the tiny ladder on the device (CUDA unless ``--device cpu``;
``--sizes`` picks models, ``--steps`` shortens every model's recipe), or
restores it from the checkpoint cache under ``artifacts/ckpt_torch/``
(``--cache-dir`` names another; ``common.trained_family``), when a chosen
suite needs it (all but ``kernel``, ``serve``, ``plan`` and ``ledger``), then
runs each suite; the kernel microbench (``kernel_bench``), the serving bench
(``serve_bench.run``: static vs continuous batching over kv16/8/4 on
tiny-160k), the plan suite (``fig_mixed_frontier.run_plan``: plans for
random-init archs under ``artifacts/plans/``), the regression ledger's
pinned records (``ledger.run``: candidates under artifacts/bench_torch/) and
the roofline (``roofline.run``: the dry-run's records under
``artifacts/dryrun_torch/``, ``launch/dryrun.py``) train nothing.  Prints
``name,us_per_call,derived`` CSV rows (plus human-readable logs on stderr)
and writes machine-readable results under artifacts/bench_torch/.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.paper import (appb_centering, common, fig2_bitlevel, fig3_blocksize,
                               fig3_datatypes, fig4_proxy, fig_mixed_frontier, kernel_bench,
                               ledger, roofline, serve_bench, table1_gptq)

SUITES = {
    "fig2": fig2_bitlevel.run,
    "fig3dt": fig3_datatypes.run,
    "fig3bs": fig3_blocksize.run,
    "fig4": fig4_proxy.run,
    "table1": table1_gptq.run,
    "appb": appb_centering.run,
    "kernel": kernel_bench.run,
    "roofline": roofline.run,
    "serve": serve_bench.run,
    "figmix": fig_mixed_frontier.run,
    "plan": fig_mixed_frontier.run_plan,
    "ledger": ledger.run,
}
#: the suites that run on the trained ladder
ON_FAMILY = ("fig2", "fig3dt", "fig3bs", "fig4", "table1", "appb", "figmix")
#: the suites that read records and run nothing (the roofline: the dry-run's)
RECORDS_ONLY = ("roofline",)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help=f"comma list of {','.join(SUITES)}")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--sizes", default=None, help="comma list of tiny-ladder models "
                    "(default: all four)")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps for every model (default: TRAIN_RECIPE)")
    ap.add_argument("--cache-dir", default=None,
                    help="the ladder's checkpoint cache (default: artifacts/ckpt_torch)")
    args = ap.parse_args(argv)
    wanted = [n for n in args.only.split(",") if n] if args.only else list(SUITES)
    unknown = sorted(set(wanted) - set(SUITES))
    if unknown:
        ap.error(f"unknown suite(s) {unknown}; valid: {sorted(SUITES)}")
    if not wanted:
        ap.error("--only names no suites")
    sizes = args.sizes.split(",") if args.sizes else None
    family = (common.trained_family(sizes, log=log, device=args.device, steps=args.steps,
                                    cache_dir=args.cache_dir)
              if any(n in ON_FAMILY for n in wanted) else None)
    print("name,us_per_call,derived")
    for name in wanted:
        t0 = time.time()
        log(f"\n==== {name} ====")
        if name in ON_FAMILY:
            rows, _ = SUITES[name](family, log=log)
        elif name in RECORDS_ONLY:   # as the reference's suite runner calls it
            rows, _ = SUITES[name](log=log)
        else:   # as the reference's suite runner calls it (kernel: no gate)
            rows, _ = SUITES[name](log=log, device=args.device, cli_args=vars(args))
        for r in rows:
            print(f"{r[0]},{r[1]:.1f},{r[2]}", flush=True)
        log(f"[{name} done in {time.time()-t0:.0f}s]")


if __name__ == "__main__":
    main()
