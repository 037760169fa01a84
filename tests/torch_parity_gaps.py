"""Print the port's measured gaps to the JAX package on the inputs of
``test_torch_quant_methods.py`` and ``test_torch_gptq.py``: what their
tolerances were set from, how far ``torch.mean`` is from ``jnp.mean`` and
an f32 ``torch.sqrt`` from ``jnp.std``'s root (fault C2, closed).  On the
CPU, with jax installed:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity_gaps.py
"""

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import test_torch_gptq as tg  # noqa: E402
import test_torch_quant_methods as tm  # noqa: E402
from repro_torch.kernels.ref import quantize_blocks_ref  # noqa: E402


def main():
    for block in (64, 128, 1024):
        n = 2000 if block < 1024 else 400
        x = tm._blocks(n, block, seed=block)
        ref = np.asarray(jnp.mean(jnp.asarray(x), axis=1))
        off = int((torch.from_numpy(x).mean(dim=1).numpy() != ref).sum())
        xla = int((tm.tb.mean_xla(torch.from_numpy(x), 1).numpy() != ref).sum())
        # what torch.mean's means did to the centered encode: bf16 means, codes
        enc = tm.rb.encode(jnp.asarray(x), tm.r_make_codebook("int", 4), block, centering=True)
        t_mean = torch.from_numpy(x).mean(dim=1, keepdim=True)
        codes, _ = quantize_blocks_ref(torch.from_numpy(x) - t_mean,
                                       tm.make_codebook("int", 4, device="cpu"))
        bf16 = int((t_mean[:, 0].to(torch.bfloat16).float().numpy()
                    != np.asarray(enc.means).astype(np.float32)).sum())
        flips = int((codes.numpy() != np.asarray(enc.codes)).sum())
        print(f"C2 B={block}: torch.mean off jnp.mean on {off} of {n} blocks "
              f"({off / n:.1%}), mean_xla on {xla}; with torch.mean {bf16} bf16 means "
              f"and {flips} of {n * block} codes differ")
    for rows, cols in tm.STD_SHAPES:
        w = (np.random.RandomState(rows * 7 + cols).randn(rows, cols) * 0.02).astype(np.float32)
        ref = np.asarray(jnp.std(jnp.asarray(w), axis=0)).view(np.int32)
        var = torch.from_numpy(np.asarray(jnp.var(jnp.asarray(w), axis=0)))
        f32 = int((torch.sqrt(var).numpy().view(np.int32) != ref).sum())
        port = int((tm.tproxy.hidden_unit_std(torch.from_numpy(w)).numpy().view(np.int32)
                    != ref).sum())
        print(f"C2 std {rows}x{cols}: an f32 torch.sqrt of jnp.var off jnp.std on {f32} of "
              f"{cols} units, std_xla (f64 root) on {port}")
    for case in tm.CASES:
        shape, bd, axis, bits, centering = case
        rs = np.random.RandomState(sum(shape) + bits)
        x = (rs.randn(*shape) * 0.05).astype(np.float32)
        kw = dict(bits=bits, block_size=64, batch_dims=bd, centering=centering)
        if axis is not None:
            items = int(np.prod(shape[:bd])) if bd else 1
            idx = np.stack([np.sort(rs.choice(shape[bd:][axis], 3, replace=False))
                            for _ in range(items)]).astype(np.int32).reshape(shape[:bd] + (3,))
            kw.update(outlier_axis=axis)
        ref = tm.rq.quantize_tensor(jnp.asarray(x), outlier_idx=None if axis is None
                                    else jnp.asarray(idx), **kw)
        port = tm.tq.quantize_tensor(tm._t(x), outlier_idx=None if axis is None
                                     else tm._t(idx), **kw)
        r = float(tm.rq.quantization_error(jnp.asarray(x), ref))
        t = float(tm.tq.quantization_error(tm._t(x), port))
        print(f"quantization_error {case}: relative gap {abs(t - r) / r:.2e}")
    w, xin = tg._inputs()
    gaps = []
    for bits in (2, 3):
        cb = np.asarray(tg.r_make_codebook("int", bits))
        for block in (None, 32, 64):
            ref = tg.rgptq.gptq_quantize(w, tg.rgptq.hessian_from_inputs(xin), cb,
                                         block_size=block)
            port = tg.tgptq.gptq_quantize(torch.from_numpy(w),
                                          tg.tgptq.hessian_from_inputs(torch.from_numpy(xin)),
                                          torch.from_numpy(cb.copy()), block_size=block)
            gaps.append(tg._rel(port.numpy(), ref))
    print(f"gptq_quantize: max relative gap {max(gaps):.2e}")
    for name in ("tiny-160k", "tiny-650k"):
        rcfg, tcfg = tg.r_get_arch(name), tg.get_arch(name)
        weights = tg._trained(name)
        toks = np.asarray(tg.rcommon.eval_tokens(rcfg))
        calib = np.asarray(tg.rcommon.eval_tokens(rcfg, n_seqs=8, seed=777))[:, :128]
        r_params = tg.jax.tree.map(jnp.asarray, weights)
        t_params = tg.interop.params_from_reference(weights, device="cpu")
        for bits, block in ((2, 64), (2, 1024), (3, None)):
            r = tg.r_perplexity(tg.rtable1._gptq_model(rcfg, r_params, jnp.asarray(calib),
                                                       bits=bits, block_size=block),
                                rcfg, jnp.asarray(toks))
            t = tg.perplexity(tg.ttable1._gptq_model(tcfg, t_params,
                                                     torch.from_numpy(calib.copy()),
                                                     bits=bits, block_size=block),
                              tcfg, torch.from_numpy(toks.copy()), device="cpu")
            print(f"_gptq_model {name} {bits}-bit block {block}: perplexity "
                  f"{t:.4f} vs {r:.4f}, relative gap {abs(t / r - 1):.2e}")


if __name__ == "__main__":
    main()
