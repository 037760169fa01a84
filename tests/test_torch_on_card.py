"""The port's serving path on the card: cases that need a CUDA GPU, marked
``cuda`` and skipped without one.  The file imports no JAX, so it also runs
where the card is (a machine without JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_on_card.py

* the fused attention's kernel at [B] positions with idle rows against its
  plain version: within 2^-6 of each row's max (two bf16 ulps, the gate of
  chip_smoke.py), idle rows exactly 0;
* the captured decode step (``Engine.generate``) against eager
  ``lm.decode_step`` calls, token for token, greedy and sampled (the same
  generator seed, the same tokens and the same generator state after);
  one captured step a batch size whatever the temperature or generator;
  the launch counters tick at each replay as at an eager step;
* the Server's chunked prefill: a chunk size off ``attention.Q_PIECE`` is
  refused, and a bucket capped at a cache length off it serves the tokens
  of an unchunked Server.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import QuantConfig, get_arch
from repro_torch.kernels import kv_attention as tka
from repro_torch.kernels import kv_dequant as tkv
from repro_torch.kernels import launches
from repro_torch.models import lm
from repro_torch.models.quantize import quantize_params
from repro_torch.serving import Engine, Server, Telemetry
from repro_torch.serving.engine import sample_token

ATT_TOL = 2.0 ** -6          # two bf16 ulps at the row's max


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built with nvcc and run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K_,G_,Dh", [(2, 7, 32), (4, 7, 128), (2, 4, 64)])
def test_fused_attention_kernel_at_vector_positions(bits, K_, G_, Dh):
    """[B] positions over a [B, S] position array with idle rows: the kernel
    within 2^-6 of each row's max of its plain version, idle rows exactly
    0."""
    _need_cuda()
    Bc, Sc = 8, 300
    rs = np.random.RandomState(bits + Dh)
    spec = tkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
    feat = K_ * Dh
    k = torch.tensor(rs.randn(Bc, Sc, feat), dtype=torch.bfloat16, device="cuda")
    v = torch.tensor(rs.randn(Bc, Sc, feat), dtype=torch.bfloat16, device="cuda")
    kp, ks = tkv.encode_rows(k, spec)
    vp, vs = tkv.encode_rows(v, spec)
    lens = rs.randint(1, Sc, Bc)
    ar = np.arange(Sc)
    pos_arr = np.stack([np.where(ar < n, ar, -1) for n in lens]).astype(np.int32)
    pos = (lens - 1).astype(np.int32)
    pos[[1, 5]] = -1
    cache = {"k_packed": kp, "k_scales": ks, "v_packed": vp, "v_scales": vs,
             "pos": torch.from_numpy(pos_arr).cuda()}
    q = torch.tensor(rs.randn(Bc, K_ * G_, Dh) * 2, dtype=torch.bfloat16, device="cuda")
    p = torch.from_numpy(pos).cuda()
    out = tka.decode_attention_packed_cuda(q, cache, p, spec).float()
    plain = tka.decode_attention_packed_plain(q, cache, p, spec).float()
    torch.cuda.synchronize()
    gap = (out - plain).abs().amax(-1)
    assert bool((gap <= ATT_TOL * plain.abs().amax(-1)).all()), float(gap.max())
    assert not bool(out[[1, 5]].abs().any()) and not bool(plain[[1, 5]].abs().any())
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [16, 8, 4])
def test_engine_graph_tokens_equal_eager(kv):
    """The captured step replays the kernels eager ``lm.decode_step`` calls
    launch, at the same shapes: identical greedy tokens."""
    _need_cuda()
    cfg = get_arch("tiny-650k")
    if kv < 16:
        cfg = cfg.with_kv_quant(kv)
    params = quantize_params(lm.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16),
                             QuantConfig(bits=4), cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    n = 24
    graph = Engine(params, cfg, max_seq_len=16 + n, device="cuda").generate(prompts, n)
    logits, caches = lm.prefill(params, prompts, cfg, cache_len=16 + n)
    tok = torch.argmax(logits, -1).to(torch.int32)
    eager = [tok]
    for t in range(1, n):
        logits, caches = lm.decode_step(params, tok, caches, 16 + t - 1, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        eager.append(tok)
    assert torch.equal(graph, torch.stack(eager, 1))


@pytest.mark.cuda
def test_engine_graph_samples_with_a_registered_generator():
    """Temperature sampling inside the captured step draws from the caller's
    generator (registered with the graph): the same seed gives the same
    tokens, in range, and a high temperature leaves the greedy path."""
    _need_cuda()
    cfg = get_arch("tiny-160k").with_kv_quant(4)
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (4, 8), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(2))
    engine = Engine(params, cfg, max_seq_len=24, device="cuda")
    gen = torch.Generator("cuda")
    runs = [engine.generate(prompts, 12, temperature=100.0, generator=gen.manual_seed(5))
            for _ in range(2)]
    greedy = engine.generate(prompts, 12)
    assert torch.equal(runs[0], runs[1])
    assert bool(((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all())
    assert not torch.equal(runs[0], greedy)


def _q4_params(cfg):
    return quantize_params(lm.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16),
                           QuantConfig(bits=4), cfg, device="cuda")


def _eager(params, cfg, prompts, n, temperature, generator, cache_len):
    """n tokens of eager lm.decode_step calls sampled as Engine.generate
    samples them."""
    logits, caches = lm.prefill(params, prompts, cfg, cache_len=cache_len)
    tok = sample_token(logits, generator, temperature)
    out = [tok]
    for t in range(1, n):
        logits, caches = lm.decode_step(params, tok, caches, prompts.shape[1] + t - 1, cfg)
        tok = sample_token(logits, generator, temperature)
        out.append(tok)
    return torch.stack(out, 1)


@pytest.mark.cuda
def test_engine_graph_sampling_equals_eager_one_graph_a_batch():
    """Sampling inside the captured step draws what eager steps draw from
    the same generator state, and leaves the caller's generator where the
    eager steps leave it (the default generator too); a new temperature or
    generator replays the batch size's one captured step."""
    _need_cuda()
    cfg = get_arch("tiny-650k").with_kv_quant(4)
    params = _q4_params(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (3, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
    n = 20
    engine = Engine(params, cfg, max_seq_len=16 + n, device="cuda")
    for temperature, seed in ((0.8, 7), (1.5, 8)):
        mine = torch.Generator("cuda").manual_seed(seed)
        theirs = torch.Generator("cuda").manual_seed(seed)
        graph = engine.generate(prompts, n, temperature=temperature, generator=mine)
        eager = _eager(params, cfg, prompts, n, temperature, theirs, 16 + n)
        assert torch.equal(graph, eager), temperature
        assert torch.equal(mine.get_state(), theirs.get_state())
    torch.cuda.manual_seed(11)
    graph = engine.generate(prompts, n, temperature=0.8)
    torch.cuda.manual_seed(11)
    assert torch.equal(graph, _eager(params, cfg, prompts, n, 0.8, None, 16 + n))
    assert list(engine._graphs) == [3]


@pytest.mark.cuda
def test_replays_count_their_launches():
    """A replay of the captured step adds the launches of one eager decode
    step to the wrappers' counters; capturing adds the warm-up's only."""
    _need_cuda()
    cfg = get_arch("tiny-650k").with_kv_quant(4)
    params = _q4_params(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(4))
    n = 10
    logits, caches = lm.prefill(params, prompts, cfg, cache_len=16 + n)
    before = launches.snapshot()
    lm.decode_step(params, torch.argmax(logits, -1).to(torch.int32), caches, 16, cfg)
    step = [a - b for a, b in zip(launches.snapshot(), before)]
    before = launches.snapshot()
    lm.prefill(params, prompts, cfg, cache_len=16 + n)
    prefill = [a - b for a, b in zip(launches.snapshot(), before)]
    assert sum(step) > 0 and sum(prefill) > 0
    engine = Engine(params, cfg, max_seq_len=16 + n, device="cuda")
    for captures in (1, 0):    # the first call captures: one warm-up step
        before = launches.snapshot()
        engine.generate(prompts, n)
        got = [a - b for a, b in zip(launches.snapshot(), before)]
        assert got == [p + (n - 1 + captures) * s for p, s in zip(prefill, step)], captures


@pytest.mark.cuda
def test_server_refuses_chunks_off_the_query_piece():
    _need_cuda()
    cfg = get_arch("tiny-160k")
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        Server(params, cfg, num_slots=2, max_seq_len=256, prefill_chunk=100, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [16, 4])
def test_chunked_prefill_of_a_capped_bucket_token_identical(kv):
    """A cache of 576 slots caps a 520-token prompt's bucket at 576, off
    the 128-row pieces, so it prefills plainly; prompts of 300 and 200
    tokens chunk at buckets of 512 and 256.  Either way the tokens are the
    unchunked Server's."""
    _need_cuda()
    cfg = get_arch("tiny-650k")
    cfg = cfg.with_kv_quant(kv) if kv < 16 else cfg
    params = _q4_params(cfg)
    rs = np.random.RandomState(kv)
    prompts = [rs.randint(0, cfg.vocab_size, L) for L in (520, 300, 200)]
    budgets = [16, 12, 8]

    def serve(**kw):
        srv = Server(params, cfg, num_slots=2, max_seq_len=576, device="cuda", **kw)
        ids = [srv.submit(p, m, arrival_time=float(i))
               for i, (p, m) in enumerate(zip(prompts, budgets))]
        res = srv.run_until_drained()
        return [res[i] for i in ids]

    plain = serve()
    tel = Telemetry()
    assert serve(prefill_chunk=128, telemetry=tel) == plain
    assert [len(t) for t in plain] == budgets
    # 3 + 2 chunks; the capped bucket prefills plainly
    assert tel.registry.counter("serve_prefill_chunks_total").value == 5
