"""The paper's experiments on the port — port of ``benchmarks/run.py`` for the
suites of this slice.

    PYTHONPATH=src python -m repro_torch.paper.run [--only fig2,fig3dt,fig3bs]
        [--device cpu] [--sizes tiny-160k,tiny-650k] [--steps N]

Trains the tiny ladder once on the device (CUDA unless ``--device cpu``;
``--sizes`` picks models, ``--steps`` shortens every model's recipe), then
runs each suite on it.  Prints ``name,us_per_call,derived`` CSV rows (plus
human-readable logs on stderr) and writes machine-readable results under
artifacts/bench_torch/.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.paper import common, fig2_bitlevel, fig3_blocksize, fig3_datatypes

SUITES = {
    "fig2": fig2_bitlevel.run,
    "fig3dt": fig3_datatypes.run,
    "fig3bs": fig3_blocksize.run,
}


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
    args = ap.parse_args(argv)
    wanted = [n for n in args.only.split(",") if n] if args.only else list(SUITES)
    unknown = sorted(set(wanted) - set(SUITES))
    if unknown:
        ap.error(f"unknown suite(s) {unknown}; valid: {sorted(SUITES)}")
    if not wanted:
        ap.error("--only names no suites")
    sizes = args.sizes.split(",") if args.sizes else None
    family = common.trained_family(sizes, log=log, device=args.device, steps=args.steps)
    print("name,us_per_call,derived")
    for name in wanted:
        t0 = time.time()
        log(f"\n==== {name} ====")
        rows, _ = SUITES[name](family, log=log)
        for r in rows:
            print(f"{r[0]},{r[1]:.1f},{r[2]}", flush=True)
        log(f"[{name} done in {time.time()-t0:.0f}s]")


if __name__ == "__main__":
    main()
