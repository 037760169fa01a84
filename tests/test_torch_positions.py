"""Decode positions in device memory: the port's cache write, decode
attention and decode step at a 0-d or a [B] int32 tensor position against
the JAX package's.

* ``attention.write_cache_decode``: every cache leaf bit-identical to the
  reference's after a write at a 0-d position (a shared [S] position array)
  and at a [B] one (a per-slot [B, S] array, idle rows at -1 landing at a
  clamped slot with pos -1), at kv16, kv8 and kv4;
* ``attention.decode_attention`` over the written cache: within 2^-6 of each
  row's max (two bf16 ulps, the fused attention's gate) of the reference's,
  an idle row exactly zero in both;
* ``lm.decode_step`` with tensor positions over per-slot caches, rows
  joining and idling: logits within 0.08 of the reference's
  (tests/test_decode_consistency.py's bar), compiled without XLA's excess
  precision as in tests/test_torch_model.py.

The same forms on the card (the fused attention's kernel at [B] positions,
the captured decode step) are held in tests/test_torch_on_card.py, which
imports no JAX and so also runs where the card is.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.kernels import kv_dequant as rkv  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import dequantize_params as r_dequantize_params  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.kernels import kv_attention as tka  # noqa: E402
from repro_torch.kernels import kv_dequant as tkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402

torch.set_num_threads(2)

ATT_TOL = 2.0 ** -6          # two bf16 ulps at the row's max
LOGIT_TOL = 0.08             # tests/test_decode_consistency.py
NO_EXCESS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
B, S, K, G, DH = 4, 12, 2, 2, 32


def _t(a, device="cpu"):
    return interop.tensor_from_numpy(np.asarray(a), device=device)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _spec(kv):
    if kv == 16:
        return None, None
    return (rkv.KVQuantSpec(bits=kv, block_size=64, dtype_name="float"),
            tkv.KVQuantSpec(bits=kv, block_size=64, dtype_name="float"))


def _filled_cache(kv, per_slot, seed):
    """A cache with earlier content at positions 0..5 (per row when
    per_slot: row b holds 6 - b of them), as the reference's arrays."""
    rs = np.random.RandomState(seed)
    r_spec, _ = _spec(kv)
    k = jnp.asarray(rs.randn(B, S, K, DH), jnp.bfloat16)
    v = jnp.asarray(rs.randn(B, S, K, DH), jnp.bfloat16)
    if r_spec is None:
        cache = {"k": k, "v": v}
    else:
        kp, ks = rkv.encode_rows(k.reshape(B, S, K * DH), r_spec)
        vp, vs = rkv.encode_rows(v.reshape(B, S, K * DH), r_spec)
        cache = {"k_packed": kp, "k_scales": ks, "v_packed": vp, "v_scales": vs}
    ar = np.arange(S)
    if per_slot:
        pos = np.stack([np.where(ar < 6 - b, ar, -1) for b in range(B)])
    else:
        pos = np.where(ar < 6, ar, -1)
    cache["pos"] = jnp.asarray(pos.astype(np.int32))
    return cache


FORMS = {"shared": (False, np.int32(6)),
         "per_row": (True, np.array([6, -1, 4, 11], dtype=np.int32))}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("kv", [16, 8, 4])
def test_write_and_attention_match_reference(kv, form):
    per_slot, pos = FORMS[form]
    r_spec, t_spec = _spec(kv)
    cache = _filled_cache(kv, per_slot, seed=kv + per_slot)
    rs = np.random.RandomState(3)
    k_new = jnp.asarray(rs.randn(B, K, DH), jnp.bfloat16)
    v_new = jnp.asarray(rs.randn(B, K, DH), jnp.bfloat16)
    q = jnp.asarray(rs.randn(B, K * G, DH) * 2, jnp.bfloat16)

    def ref_fn(cache, k_new, v_new, q, pos):
        c = rattn.write_cache_decode(cache, k_new, v_new, pos, kvq=r_spec)
        return c, rattn.decode_attention(q, c, pos, kvq=r_spec)

    r_cache, r_out = jax.jit(ref_fn)(cache, k_new, v_new, q, jnp.asarray(pos))
    t_cache = {key: _t(val) for key, val in cache.items()}
    t_pos = torch.from_numpy(np.asarray(pos)).reshape(np.shape(pos))
    tattn.write_cache_decode(t_cache, _t(k_new), _t(v_new), t_pos, kvq=t_spec)
    for key in t_cache:
        assert np.array_equal(_bits(t_cache[key]), _bits(_t(r_cache[key]))), key
    out = tattn.decode_attention(_t(q), t_cache, t_pos, kvq=t_spec).float().numpy()
    ref = np.asarray(r_out.astype(jnp.float32))
    gap = np.abs(out - ref).max(-1)
    assert (gap <= ATT_TOL * np.abs(ref).max(-1)).all(), gap.max()
    if per_slot:
        idle = np.asarray(pos) < 0
        assert not out[idle].any() and not ref[idle].any()


def test_idle_rows_clamp_and_read_as_empty():
    """Writes of idle rows park pos -1 at slot 0 of their row; the row's
    attention output is exactly zero through the packed plain version."""
    _, t_spec = _spec(4)
    cache = {k: _t(v) for k, v in _filled_cache(4, True, seed=1).items()}
    before = cache["pos"].clone()
    pos = torch.tensor([3, -1, -1, 7], dtype=torch.int32)
    k_new = torch.randn(B, K, DH).to(torch.bfloat16)
    tattn.write_cache_decode(cache, k_new, k_new, pos, kvq=t_spec)
    assert cache["pos"][1, 0] == -1 and cache["pos"][2, 0] == -1
    assert torch.equal(cache["pos"][1, 1:], before[1, 1:])
    assert cache["pos"][0, 3] == 3 and cache["pos"][3, 7] == 7
    q = torch.randn(B, K * G, DH).to(torch.bfloat16)
    out = tka.decode_attention_packed(q, cache, pos, t_spec)
    assert not out[1:3].float().abs().any() and out[0].float().abs().any()
    with pytest.raises(ValueError, match="position"):
        tka.decode_attention_packed(q, cache, torch.tensor(3, dtype=torch.int32), t_spec)
    with pytest.raises(ValueError, match="per-slot"):
        tattn.write_cache_decode({"k": torch.zeros(B, S, K, DH), "v": torch.zeros(B, S, K, DH),
                                  "pos": torch.full((S,), -1, dtype=torch.int32)},
                                 k_new, k_new, pos)


@functools.lru_cache(maxsize=None)
def _weights(name, weights):
    rcfg = r_get_arch(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(0))
    if weights == "w16":
        return raw, interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu")
    q = jax.jit(lambda p: r_quantize_params(
        p, RQuantConfig(bits=4, dtype="float", block_size=64), rcfg))(raw)
    port = quantize_params(interop.params_from_reference(jax.tree.map(np.asarray, raw),
                                                         device="cpu"),
                           QuantConfig(bits=4, dtype="float", block_size=64), get_arch(name),
                           device="cpu")
    return jax.jit(r_dequantize_params)(q), port


# rows join and idle: (per-step positions [B]); -1 = idle
SCHEDULE = [[0, -1, -1, 0], [1, 0, -1, 1], [2, 1, 0, -1], [3, 2, 1, -1], [-1, 3, 2, 0],
            [0, 4, 3, 1]]


@pytest.mark.parametrize("weights", ["w16", "q4"])
@pytest.mark.parametrize("kv", [16, 8, 4])
def test_decode_step_vector_positions_match_reference(kv, weights):
    """Per-slot caches decoded from empty at per-row positions, rows joining,
    idling and restarting (a new request in a freed slot): logits of busy
    rows within the decode-consistency bar, idle rows' caches untouched
    beyond their clamped write."""
    name = "tiny-160k"
    rcfg, tcfg = r_get_arch(name), get_arch(name)
    if kv < 16:
        rcfg, tcfg = rcfg.with_kv_quant(kv), tcfg.with_kv_quant(kv)
    r_params, t_params = _weights(name, weights)
    r_caches = rlm.init_caches(rcfg, B, 8, per_slot=True)
    t_caches = lm.init_caches(tcfg, B, 8, per_slot=True, device="cpu")
    tok = np.random.RandomState(kv).randint(0, tcfg.vocab_size, (len(SCHEDULE), B))
    step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, t, c, pos, rcfg)).lower(
        r_params, jnp.asarray(tok[0], jnp.int32), r_caches,
        jnp.asarray(SCHEDULE[0], jnp.int32)).compile(compiler_options=NO_EXCESS)
    for t, pos in enumerate(SCHEDULE):
        pos = np.asarray(pos, np.int32)
        r_logits, r_caches = step(r_params, jnp.asarray(tok[t], jnp.int32), r_caches,
                                  jnp.asarray(pos))
        t_logits, _ = lm.decode_step(t_params, torch.from_numpy(tok[t].astype(np.int32)),
                                     t_caches, torch.from_numpy(pos), tcfg)
        busy = pos >= 0
        gap = np.abs(t_logits.float().numpy() - np.asarray(r_logits, np.float32))[busy].max()
        assert gap < LOGIT_TOL, (t, gap)
    assert np.array_equal(t_caches[0]["pos"].numpy(), np.asarray(r_caches[0]["pos"]))


def test_decode_step_takes_int_and_0d_positions_alike():
    """An int position is filled on the device once; a 0-d tensor is used as
    given: the same logits and caches."""
    cfg = get_arch("tiny-160k").with_kv_quant(4)
    _, params = _weights("tiny-160k", "q4")
    out = []
    for pos in (3, torch.tensor(3, dtype=torch.int32)):
        caches = lm.init_caches(cfg, 2, 6, device="cpu")
        logits, _ = lm.decode_step(params, torch.tensor([5, 9], dtype=torch.int32), caches,
                                   pos, cfg)
        out.append((logits, caches))
    assert torch.equal(out[0][0], out[1][0])
    for key in out[0][1][0]:
        assert torch.equal(out[0][1][0][key], out[1][1][0][key])
