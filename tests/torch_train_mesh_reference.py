"""The reference's sharded train-step gradients on forced host devices, for
``tests/test_torch_train_mesh.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/torch_train_mesh_reference.py --mesh 2x2 --inp in.pkl --out out.npz

``--inp`` is the pickle the test writes for its gloo worlds ({"raw": the
reference's init of the arch as numpy, "tokens", "labels": the batch,
"loss_chunk"}); ``--arch`` names the arch (tiny-650k by default),
``--reduced`` takes its ``reduced()`` config.  The mesh is ``jax.make_mesh(shape, ("data", "model"),
axis_types=Auto)`` (jax 0.9's default axes are Explicit, which
``with_sharding_constraint`` refuses), entered with ``with mesh:``, and the
``Sharder`` replicates nothing (``replicate_params_below=0``), as the
port's worlds do.  Writes the loss and every gradient leaf (f32, keyed by
``jax.tree_util.keystr``) of ``jax.value_and_grad`` of ``lm.loss_fn`` with
the sharder's ``constrain`` and ``head_pad()``, the params placed by
``param_spec_tree`` and the batch over "data".
"""

from __future__ import annotations

import argparse
import pickle
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, metavar="DATAxMODEL")
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--arch", default="tiny-650k")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_arch
    from repro.models import lm
    from repro.models.sharding import Sharder

    with open(args.inp, "rb") as f:
        inp = pickle.load(f)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = tuple(int(p) for p in args.mesh.split("x"))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    with mesh:
        sharder = Sharder(mesh, cfg, replicate_params_below=0)
        params = jax.tree.map(jnp.asarray, inp["raw"])
        params = jax.device_put(params, sharder.param_spec_tree(params))
        rows = NamedSharding(mesh, P("data", None))
        tokens = jax.device_put(jnp.asarray(inp["tokens"]), rows)
        labels = jax.device_put(jnp.asarray(inp["labels"]), rows)

        def loss(p, t, y):
            return lm.loss_fn(p, t, y, cfg, constrain=sharder.constrain,
                              q_pad=sharder.head_pad(), loss_chunk=inp["loss_chunk"])

        value, grads = jax.jit(jax.value_and_grad(loss))(params, tokens, labels)
    flat = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(grads)}
    np.savez(args.out, loss=np.float32(value), **flat)


if __name__ == "__main__":
    main()
