"""The port's GPTQ (``core/gptq.py``, torch float64) and Table 1's sequential
GPTQ (``paper/table1_gptq._gptq_model``) against the JAX package's.

The bars:
  * ``hessian_from_inputs``: within 1e-15 relative (one float64 product in
    another BLAS);
  * ``gptq_quantize`` on a seeded 96 x 64 weight with two dead inputs, at 2
    and 3 bits, blocked (32, 64) and unblocked: within 1e-12 relative of the
    reference's numpy float64 (up to 4.4e-16: the inverse and
    Cholesky factor come from another LAPACK, and a weight would have to lie
    within ~1e-15 of a rounding midpoint to flip);
  * ``_gptq_model`` on trained tiny-160k with the reference's calibration
    and evaluation tokens: perplexity within 5e-3 relative.  The layer
    inputs that feed the Hessians are bf16 activations, and the two
    packages' activations differ in single bf16 roundings; a Hessian a few
    ulps off moves the weights that lie near a rounding midpoint to the
    other code.  Measured: 4.8e-6 to 5.3e-5 on tiny-160k and 7.7e-5 to
    1.2e-3 on tiny-650k (2-bit at blocks 64 and 1024, 3-bit unblocked;
    ``tests/torch_parity_gaps.py`` prints them).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # benchmarks/ is a repo-root package

from benchmarks import common as rcommon  # noqa: E402
from benchmarks import table1_gptq as rtable1  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.core import gptq as rgptq  # noqa: E402
from repro.core.codebooks import make_codebook as r_make_codebook  # noqa: E402
from repro.serving import perplexity as r_perplexity  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import gptq as tgptq  # noqa: E402
from repro_torch.paper import table1_gptq as ttable1  # noqa: E402
from repro_torch.serving import perplexity  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(2)

GPTQ_REL = 1e-12
MODEL_PPL_REL = 5e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def _inputs():
    rs = np.random.RandomState(0)
    w = (rs.randn(96, 64) * 0.1).astype(np.float32)
    x = rs.randn(256, 96).astype(np.float32)
    x[:, [3, 50]] = 0.0   # dead inputs: zero Hessian diagonal
    return w, x


def test_hessian_from_inputs_matches_reference():
    _, x = _inputs()
    assert _rel(tgptq.hessian_from_inputs(torch.from_numpy(x)).numpy(),
                rgptq.hessian_from_inputs(x)) <= 1e-15


@pytest.mark.parametrize("block", [None, 32, 64])
@pytest.mark.parametrize("bits", [2, 3])
def test_gptq_quantize_matches_reference(bits, block):
    w, x = _inputs()
    cb = np.asarray(r_make_codebook("int", bits))
    ref = rgptq.gptq_quantize(w, rgptq.hessian_from_inputs(x), cb, block_size=block)
    port = tgptq.gptq_quantize(torch.from_numpy(w), tgptq.hessian_from_inputs(torch.from_numpy(x)),
                               torch.from_numpy(cb.copy()), block_size=block)
    assert port.dtype == torch.float64
    assert _rel(port.numpy(), ref) <= GPTQ_REL
    assert np.all(port.numpy()[[3, 50]] == 0.0)   # dead inputs zeroed


@functools.lru_cache(maxsize=None)
def _trained(name):
    state, _ = tloop.train(get_arch(name), steps=30, batch=8, seq_len=64, device="cpu",
                           log=lambda *_: None)
    return tree_map(lambda t: t.numpy(), state.params)


@pytest.mark.parametrize("bits,block", [(2, 64), (3, None)])
def test_gptq_model_perplexity_matches_reference(bits, block):
    """Sequential GPTQ through the port's project_qkv, flash_attention and
    layers, on the reference's calibration and evaluation tokens."""
    name = "tiny-160k"
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    weights = _trained(name)
    toks = np.asarray(rcommon.eval_tokens(rcfg))
    calib = np.asarray(rcommon.eval_tokens(rcfg, n_seqs=8, seed=777))[:, :128]
    r_params = jax.tree.map(jnp.asarray, weights)
    r_ppl = r_perplexity(rtable1._gptq_model(rcfg, r_params, jnp.asarray(calib), bits=bits,
                                             block_size=block), rcfg, jnp.asarray(toks))
    t_params = interop.params_from_reference(weights, device="cpu")
    t_model = ttable1._gptq_model(tcfg, t_params, torch.from_numpy(calib.copy()), bits=bits,
                                  block_size=block)
    t_ppl = perplexity(t_model, tcfg, torch.from_numpy(toks.copy()), device="cpu")
    assert abs(t_ppl / r_ppl - 1) <= MODEL_PPL_REL, (t_ppl, r_ppl)
    # the dense f32 tree of the reference, with only the stack's matrices changed
    assert t_model["embed"] is t_params["embed"]
    wq = t_model["stack"][0]["mixer"]["wq"]["w"]
    assert wq.dtype == torch.float32 and not torch.equal(wq, t_params["stack"][0]["mixer"]["wq"]["w"])
