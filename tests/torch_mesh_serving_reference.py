"""The reference's sharded teacher-forced rollout on forced host devices, for
``tests/test_torch_moe_ssm_mesh.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/torch_mesh_serving_reference.py --mesh 2x2 --inp in.pkl --out out.npz

``--inp`` is a pickle of {arch name: {"raw": the reference's init of its
``reduced()`` config as numpy, "prompts" [B, Sp], "force" [B, n] (the
tokens fed after the prefill), "S": the cache budget}}.  For each arch, on
``jax.make_mesh(shape, ("data", "model"), axis_types=Auto)`` with
``Sharder(mesh, cfg, replicate_params_below=0)``: the params placed by
``param_spec_tree``, the prefill under the sharder's ``constrain``,
``q_pad`` and ``tp_scope``, the caches placed by ``cache_spec_tree`` and n
- 1 decode steps through ``decode_attn_fn``, as the reference's
``tests/test_sharded_serving.py`` rolls out; and the same rollout
unsharded.  Writes "<arch>_sharded" and "<arch>_plain" logits [B, n, V]
(f32).
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
    from jax.sharding import AxisType

    from repro.configs.registry import get_arch
    from repro.models import lm
    from repro.models.sharding import Sharder

    with open(args.inp, "rb") as f:
        inp = pickle.load(f)
    shape = tuple(int(p) for p in args.mesh.split("x"))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    no_excess = {"xla_allow_excess_precision": False}
    out = {}

    def rollout(cfg, params, one, sharder):
        toks, force, S = jnp.asarray(one["prompts"]), one["force"], one["S"]
        B, Sp = toks.shape
        kw, step_kw, scope = {}, {}, None
        if sharder is not None:
            params = jax.device_put(params, sharder.param_spec_tree(params))
            kw = dict(constrain=sharder.constrain, q_pad=sharder.head_pad())
            step_kw = dict(constrain=sharder.constrain,
                           decode_attn=sharder.decode_attn_fn(B, S))
            scope = sharder.tp_scope

        def pf(p, t):
            if scope is None:
                return lm.prefill(p, t, cfg, cache_len=S, **kw)
            with scope():
                return lm.prefill(p, t, cfg, cache_len=S, **kw)

        def dec(p, tok, c, pos):
            if scope is None:
                return lm.decode_step(p, tok, c, pos, cfg, **step_kw)
            with scope():
                return lm.decode_step(p, tok, c, pos, cfg, **step_kw)

        logits, caches = jax.jit(pf, compiler_options=no_excess)(params, toks)
        if sharder is not None:
            caches = jax.device_put(caches, sharder.cache_spec_tree(caches, B))
        step = jax.jit(dec, compiler_options=no_excess)
        logs = [np.asarray(logits, np.float32)]
        for t in range(force.shape[1] - 1):
            logits, caches = step(params, jnp.asarray(force[:, t]), caches, jnp.int32(Sp + t))
            logs.append(np.asarray(logits, np.float32))
        return np.stack(logs, 1)

    with mesh:
        for name, one in inp.items():
            cfg = get_arch(name).reduced()
            params = jax.tree.map(jnp.asarray, one["raw"])
            out[f"{name}_plain"] = rollout(cfg, params, one, None)
            out[f"{name}_sharded"] = rollout(cfg, params, one,
                                             Sharder(mesh, cfg, replicate_params_below=0))
    np.savez(args.out, **out)


if __name__ == "__main__":
    main()
