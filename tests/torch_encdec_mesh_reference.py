"""The reference's sharded encoder-decoder on forced host devices, for
``tests/test_torch_encdec_mesh.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/torch_encdec_mesh_reference.py --mesh 2x2 --inp in.pkl --out out.npz

``--inp`` is a pickle of {"raw": the reference's init of
seamless-m4t-large-v2's ``reduced()`` config as numpy, "frames", "bos",
"force": a served batch, "train": {"frames", "tokens", "labels"}}.  On
``jax.make_mesh(shape, ("data", "model"), axis_types=Auto)`` with
``Sharder(mesh, cfg, replicate_params_below=0)``, entered with ``with
mesh:``: the params placed by ``param_spec_tree``, ``seq2seq.prefill`` under
the sharder's ``constrain``, the caches placed as ``launch/specs._cache_specs``
places them and n teacher-forced ``seq2seq.decode_step``s (the reference's
``specs._decode_cell`` step), jitted without XLA's excess precision; and the
loss and every gradient leaf of ``seq2seq.loss_fn(constrain=, remat=True)``
over the batch placed over "data", also without excess precision.  Writes
"logits" [B, n + 1, V], "loss" and the gradients (f32, keyed by "g" and
``jax.tree_util.keystr``).
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
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_arch
    from repro.launch.specs import _cache_specs
    from repro.models import seq2seq
    from repro.models.sharding import Sharder

    with open(args.inp, "rb") as f:
        inp = pickle.load(f)
    cfg = get_arch("seamless-m4t-large-v2").reduced()
    shape = tuple(int(p) for p in args.mesh.split("x"))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    no_excess = {"xla_allow_excess_precision": False}
    out = {}
    with mesh:
        sharder = Sharder(mesh, cfg, replicate_params_below=0)
        params = jax.tree.map(jnp.asarray, inp["raw"])
        params = jax.device_put(params, sharder.param_spec_tree(params))
        frames, bos, force = (jnp.asarray(inp[k]) for k in ("frames", "bos", "force"))
        B, T = bos.shape
        pf = jax.jit(lambda p, f, t: seq2seq.prefill(p, f, t, cfg, constrain=sharder.constrain),
                     compiler_options=no_excess)
        logits, caches = pf(params, frames, bos)
        caches = jax.device_put(caches, _cache_specs(sharder, caches, B, cfg))
        step = jax.jit(lambda p, tok, c, pos: seq2seq.decode_step(
            p, tok, c, pos, cfg, constrain=sharder.constrain), compiler_options=no_excess)
        logs = [np.asarray(logits, np.float32)]
        for t in range(force.shape[1]):
            logits, caches = step(params, force[:, t], caches, jnp.int32(T + t))
            logs.append(np.asarray(logits, np.float32))
        out["logits"] = np.stack(logs, 1)

        rows = NamedSharding(mesh, P("data"))
        batch = {k: jax.device_put(jnp.asarray(v), rows) for k, v in inp["train"].items()}

        def loss(p, b):
            return seq2seq.loss_fn(p, b["frames"], b["tokens"], b["labels"], cfg,
                                   constrain=sharder.constrain, remat=True)

        value, grads = jax.jit(jax.value_and_grad(loss), compiler_options=no_excess)(
            params, batch)
    out["loss"] = np.float32(value)
    out.update({"g" + jax.tree_util.keystr(k): np.asarray(v, np.float32)
                for k, v in jax.tree_util.tree_leaves_with_path(grads)})
    np.savez(args.out, **out)


if __name__ == "__main__":
    main()
