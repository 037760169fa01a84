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
  of an unchunked Server;
* the fused attention over a paged cache (a shuffled page map with shared
  pages, holes and idle rows) bit-identical to the unpaged kernel on the
  same cache gathered into rows, at pages of 8 and 16, and its refusals;
  the paged Server's tokens equal to the slot pool's;
* B1's tensor-core GEMV at 3, 5 and 6 bits (the widths whose words do not
  hold whole groups of 4 codes) against ``qmatmul_plain``: every row count
  to 8, columns around its 16-column blocks, word counts off whole uint4s,
  scale blocks of 16, 32 and 64 and odd ones; within one bf16 ulp at max|y|;
* qmatmul.cu's GEMV (gemv_route's "simt": TF32 on the tensor cores) on
  bf16 x whose scale blocks split a group of 4 codes, within one bf16 ulp,
  and on f32 x at 3 to 8 bits, 1 to 8 rows, rows as stored with word tails,
  odd blocks, kernel_bench's and Qwen2-7B's shapes, within 2e-5 relative,
  one launch each, a row bit-identical alone and among 8; the bf16 prefill
  GEMM given rows as stored (ceil(K / cpw) words, which its launcher pads),
  against ``qmatmul_plain``;
* the f32 GEMM (``qgemm_simt``) against ``qmatmul_plain`` at the paper
  ladder's 12 matrices (M = 1024) and ragged shapes, within 2e-5 relative
  (f32 summation order), and a row's result bit-identical alone and inside
  a larger call (its K split depends on N and K only);
* the routed read of a packed cache (shapes the fused attention does not
  take: head dims 56 and 120, a 40,960-slot cache at Qwen2-7B's heads)
  against its plain version within 2^-6 of each row's max, idle rows 0,
  paged bit-identical to unpaged, the fused kernel's wrapper raising there;
  the KV dequant kernel bit-exact (one leaf, K and V in one launch, pages
  through a map); the flat encode bit-exact at blocks of 1 to 2048 on
  midpoints, ±0 and subnormals; tiny-10m at kv4 and kv8 through the
  Engine (graph tokens = eager ones) and the Server (pages = slots);
* the paper's remaining experiments: the centered flat encode (means
  bit-equal to the CPU's, codes bit-exact to the plain encode of the same
  centered blocks), the proxy encode through quantize_pack on zeroed
  transposed items (bit-identical to the CPU's, one launch an item), GPTQ on
  the card within 1e-12 of the CPU's;
* mixed-precision plans: a plan-quantized tree's words and scales on the
  card equal the CPU's bit for bit (a 16-bit unit left as it was);
  ``Engine(plan=)``'s captured steps equal eager steps; the Server under a
  plan of 3-, 5- and 6-bit units equals the batch-1 Engine token for token;
  the kv probe (``Telemetry(kv_probe_every=1)``) leaves the tokens
  unchanged and records a finite error above 0;
* sliding windows: the routed read over a wrapped 4096-slot ring (kv4 and
  kv8, Dh 120 and 128, a soft-cap, per-row positions with an idle row)
  within 2^-6 of each row's max of its plain version, the fused wrapper
  raising on the window; reduced() danube and gemma2 through the Engine
  (captured ring steps = eager ones at kv16, kv8, kv4, their launches) and
  danube's Server (= the per-request Engine; paged and chunked refused);
* mixture of experts: the expert-batched tensor-core GEMV
  (``qmatmul_gemv_experts``) bit-identical to a ``qmatmul_gemv_tc`` launch
  on each expert alone at every width and block the GEMV takes and at
  moonshot-v1's and phi3.5-moe's shapes, experts with 0, 1 and 8 rows, one
  launch; a row's output independent of its slot in the buffer and of the
  rows beside it; within one bf16 ulp of the plain version; and an MoE
  decoder (reduced() moonshot-v1 with experts of width 128) through the
  Engine (captured steps = eager ones, 3 expert GEMVs a layer and step)
  and the Server with bucketed, pad-masked prefills (= the per-request
  Engine);
* state-space and hybrid decoders: reduced() mamba2 (kv16) and jamba (kv4)
  with d 128 through the Engine (captured SSM steps, the state and conv
  updated in place, = eager ones; two GEMVs an SSM layer and step), and an
  SSM decode step of full-width mamba2 (4-bit in_proj and out_proj) whose
  row alone equals the same row among 8 bit for bit (output, state, conv);
* the encoder-decoder (reduced() seamless-m4t-large-v2, 4-bit): the prefill
  and decode steps through B1's GEMM and GEMV within 0.5 of dequant_einsum,
  and a captured ``seq2seq.decode_step`` equal to the eager one bit for bit;
* the step profiler: tiny-160k's programs cost the same on the card as on
  the CPU (FLOPs, dot FLOPs, the charged share; bytes within 1 %, the
  card's partials concatenated a row at a time), the profiled Engine's and
  paged Server's tokens and a replay's launches equal to unprofiled ones;
  gradient compression on the card bit-identical to the CPU's, one flat
  encode a leaf of 1,024 values or more;
* reprolint's captured-graph auditor (``analysis/audit.py``): tiny-160k's
  grid at kv16, kv8 and kv4 passes (the Engine, the slot, chunked and paged
  Servers, the fused 4-bit Server), and two broken bodies are caught: a
  host copy captured into the step fails ``no_host_nodes`` (PyTorch refuses
  a pageable one at capture; a pinned one is captured), and a Server that
  rebinds its token buffer after capture fails ``in_place``;
* the bench tooling (``paper/serve_bench.py``, ``paper/ledger.py``,
  ``paper/bench_diff.py``): the pinned serve record served on the card
  diffs clean (exit 0) against the reference's committed BENCH_SERVE.json,
  and Qwen2-7B at full width through ``serve_bench.run`` gives the static
  Engine's tokens in the continuous Server at kv16 and kv4;
* serving on a 1x1 mesh (NCCL at world size 1, ``models/sharding.py``):
  tiny-650k's sharded Engine at kv16, kv8 and kv4 equal bit for bit to
  eager unsharded steps reading every layer the routed way (one KV dequant
  a layer and step, no fused attention), and the sharded Server equal to
  the sharded batch-1 Engine;
* training on a 1x1 mesh: tiny-650k's sharded train steps (FSDP storage,
  bf16 masters, remat, 8-bit compression, 2 microbatches, the state
  donated) equal to the unsharded steps bit for bit, one flat encode a
  compressed leaf and step; a sharded state saved through the checkpoint
  manager reads back unsharded, through ``launch/elastic.remesh_state`` and
  through ``restore(sharder=)`` bit for bit;
* MoE, SSM and hybrid decoders on a 1x1 mesh (``-k moe_ssm_mesh``): the
  reduced() moonshot, mamba2 and jamba, 4-bit weights, whose sharded
  Engine equals eager unsharded steps over the routed read bit for bit
  (logits, prefill caches, tokens), whose sharded Server equals the
  sharded batch-1 Engine, and whose sharded train steps (moonshot, mamba2)
  equal the unsharded ones bit for bit; the expert-batched GEMV on a
  rank's slice of a stack equals the whole-stack launch's rows;
* the encoder-decoder, preemption and the profiler on a 1x1 mesh (``-k
  "encdec_mesh or preempted or profiler_dot"``): seamless's reduced()
  sharded prefill and decode steps and its sharded train steps equal to the
  unsharded ones bit for bit; tiny-650k's preempted sharded Server equal to
  the unsharded preempted Server over the routed read and to the sharded
  batch-1 Engine, spilling the same bytes; the profiled sharded Engine's
  dot FLOPs the unsharded Engine's, its collective bytes counted.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import QuantConfig, get_arch
from repro_torch.kernels import kv_attention as tka
from repro_torch.kernels import kv_dequant as tkv
from repro_torch.kernels import launches
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmatmul as tqm
from repro_torch.models import lm
from repro_torch.models.quantize import quantize_params
from repro_torch.serving import Engine, Server, Telemetry
from repro_torch.serving.engine import sample_token

ATT_TOL = 2.0 ** -6          # two bf16 ulps at the row's max
BF16_REL_TOL = 2.0 ** -7     # one bf16 ulp at max|y|
F32_REL_TOL = 2e-5           # f32 summation order (tests/test_qmatmul_parity.py)


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


def _paged_cache(bits, n_pages, ps, B, P, K, Dh, seed):
    """A page-major packed cache on the card: random rows, positions a run
    with holes, the trash page empty; a shuffled page map with a page
    shared by rows 0 and 1 and an unallocated entry."""
    rs = np.random.RandomState(seed)
    spec = tkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
    cache = {}
    for name in ("k", "v"):
        x = torch.tensor(rs.randn(n_pages, ps, K * Dh), dtype=torch.bfloat16, device="cuda")
        cache[f"{name}_packed"], cache[f"{name}_scales"] = tkv.encode_rows(x, spec)
    pos = (np.arange(n_pages * ps) % (P * ps)).reshape(n_pages, ps)
    pos[rs.rand(n_pages, ps) < 0.2] = -1
    pos[0] = -1
    cache["pos"] = torch.from_numpy(pos.astype(np.int32)).cuda()
    page_map = rs.permutation(np.arange(1, n_pages))[: B * P].reshape(B, P)
    page_map[1, 0] = page_map[0, 0]
    page_map[-1, -1] = 0
    return cache, torch.from_numpy(page_map.astype(np.int32)).cuda(), spec


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_attention_bit_identical_to_unpaged_on_gathered_cache(bits, ps):
    """The kernel reads a paged cache through its page map: the unpaged
    kernel's output on the same cache gathered into rows, bit for bit;
    within 2^-6 of each row's max of the paged plain version; idle rows 0."""
    _need_cuda()
    B, P, K, G, Dh = 6, 300 // ps, 4, 7, 128
    cache, page_map, spec = _paged_cache(bits, B * P + 3, ps, B, P, K, Dh, seed=bits + ps)
    rs = np.random.RandomState(ps)
    q = torch.tensor(rs.randn(B, K * G, Dh) * 2, dtype=torch.bfloat16, device="cuda")
    pos = torch.tensor([P * ps - 1, 40, -1, 100, P * ps - 9, -1], dtype=torch.int32,
                       device="cuda")
    before = tka.decode_attention_packed_cuda.launches
    out = tka.decode_attention_packed_cuda(q, cache, pos, spec, page_map=page_map,
                                           page_size=ps)
    assert tka.decode_attention_packed_cuda.launches == before + 1
    rows = {key: tkv.gather_pages(leaf, page_map).contiguous() for key, leaf in cache.items()}
    unpaged = tka.decode_attention_packed_cuda(q, rows, pos, spec)
    plain = tka.decode_attention_packed_plain(q, cache, pos, spec, page_map=page_map,
                                              page_size=ps).float()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), unpaged.view(torch.int16))
    gap = (out.float() - plain).abs().amax(-1)
    assert bool((gap <= ATT_TOL * plain.abs().amax(-1)).all()), float(gap.max())
    assert not bool(out[[2, 5]].abs().any()) and bool(out[[0, 1, 3, 4]].abs().any())


@pytest.mark.cuda
def test_paged_attention_refusals():
    """The wrapper refuses a page size that is not the leaves' or not a
    power of two, a page map off int32 and positions not a row each; the C
    entry refuses P * ps != S, a map without its sizes and sizes without a
    map (cudaErrorInvalidValue, 1)."""
    _need_cuda()
    B, P, ps, K, G, Dh = 2, 4, 16, 4, 7, 128
    cache, page_map, spec = _paged_cache(4, B * P + 1, ps, B, P, K, Dh, seed=3)
    q = torch.zeros((B, K * G, Dh), dtype=torch.bfloat16, device="cuda")
    pos = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    for kw in (dict(page_map=page_map, page_size=8), dict(page_map=page_map),
               dict(page_map=page_map.long(), page_size=ps), dict(page_size=ps)):
        with pytest.raises(ValueError):
            tka.decode_attention_packed_cuda(q, cache, pos, spec, **kw)
    with pytest.raises(ValueError):
        tka.decode_attention_packed_cuda(q, cache, torch.tensor(3, dtype=torch.int32,
                                                                device="cuda"), spec,
                                         page_map=page_map, page_size=ps)
    lib = tka._lib()
    out = torch.empty_like(q)
    cb = tkv.kv_codebook(spec, q.device)
    S = P * ps

    def call(map_ptr, S_, pa_stride, P_, ps_):
        return lib.kv_decode_attention(
            q.data_ptr(), cache["k_packed"].data_ptr(), cache["k_scales"].data_ptr(),
            cache["v_packed"].data_ptr(), cache["v_scales"].data_ptr(), cb.data_ptr(),
            cache["pos"].data_ptr(), pos.data_ptr(), map_ptr, out.data_ptr(), B, K * G, K,
            S_, K * Dh // 8, K * Dh // 64, 64, 4, Dh, 1, pa_stride, P_, ps_, Dh ** -0.5, 0.0,
            torch.cuda.current_stream().cuda_stream)

    assert call(page_map.data_ptr(), S, -1, P, ps) == 0
    torch.cuda.synchronize()
    for args in ((page_map.data_ptr(), S + 16, -1, P, ps),     # P * ps != S
                 (page_map.data_ptr(), S, -1, P, 12),         # not a power of two
                 (page_map.data_ptr(), S, S, P, ps),          # not page-major positions
                 (None, S, S, P, ps),                         # sizes without a map
                 (None, S, -1, 0, 0)):                        # page-major without a map
        assert call(*args) == 1, args


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [16, 4])
def test_paged_server_tokens_equal_slot_pool(kv):
    """The paged Server (its step one captured graph reading the page map
    from a device buffer) streams the slot pool's tokens, a shared-prefix
    fork among the requests; no page is left after the drain."""
    _need_cuda()
    cfg = get_arch("tiny-650k")
    cfg = cfg.with_kv_quant(kv) if kv < 16 else cfg
    params = _q4_params(cfg)
    rs = np.random.RandomState(kv + 1)
    prompts = [rs.randint(0, cfg.vocab_size, L) for L in (40, 100)]
    # a fork of the 100-token prompt's first four pages, admitted beside it
    prompts.append(np.concatenate([prompts[1][:64], rs.randint(0, cfg.vocab_size, 20)]))
    prompts += [rs.randint(0, cfg.vocab_size, L) for L in (23, 70)]

    def serve(**kw):
        srv = Server(params, cfg, num_slots=3, max_seq_len=256, device="cuda", **kw)
        ids = [srv.submit(p, 12, arrival_time=float(i)) for i, p in enumerate(prompts)]
        res = srv.run_until_drained()
        return srv, [res[i] for i in ids]

    _, slot = serve()
    srv, paged = serve(paged=True, page_size=16)
    assert paged == slot
    a = srv.pool.allocator
    assert a.cow_hits >= 4 and a.n_free == a.n_usable and not a.ref


def _b1(bits, dtype, block, K, N, rs):
    w = torch.tensor(rs.randn(K, N) * 0.05, dtype=torch.float32, device="cuda")
    return tops.prepare_operand(w, bits=bits, dtype=dtype, block_size=block)


def _gemv_tc_matches_plain(op, Ms, rs):
    """Each row count through qmatmul_gemv: one launch of the tensor-core
    GEMV, within one bf16 ulp at max|y| of the plain version."""
    for M in Ms:
        x = torch.tensor(rs.randn(M, op.k_dim), device="cuda").to(torch.bfloat16)
        xp, packed, scales = tops.pad_for_kernel(x, op)
        kw = dict(bits=op.bits, block_size=op.block_size)
        before = (tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemv_simt.launches)
        y_k = tqm.qmatmul_gemv(xp, packed, scales, op.codebook, **kw).float()
        y_p = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw).float()
        torch.cuda.synchronize()
        assert (tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemv_simt.launches) == \
            (before[0] + 1, before[1])
        err = float((y_k - y_p).abs().max())
        assert err <= BF16_REL_TOL * float(y_p.abs().max()), (M, op.k_dim, packed.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["int", "float", "dynamic"])
@pytest.mark.parametrize("bits", [3, 5, 6])
def test_tensor_core_gemv_at_3_5_6_bits_matches_plain(bits, dtype, block):
    """Rows 1 to 8 (the kernel multiplies 8 and masks the rest), columns
    around its 16-column blocks, K tails off its 16-word chunks."""
    _need_cuda()
    rs = np.random.RandomState(bits * 100 + block)
    for i, N in enumerate((8, 16, 17, 70, 512)):
        op = _b1(bits, dtype, block, (200, 328, 1000)[i % 3], N, rs)
        _gemv_tc_matches_plain(op, (1, 2, 3, 4, 5, 8), rs)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block", [(3, 12), (3, 20), (5, 12), (5, 20), (5, 44), (6, 4),
                                        (6, 12), (6, 20)])
def test_tensor_core_gemv_at_3_5_6_bits_odd_rows_and_blocks(bits, block):
    """Rows of a word count off whole uint4s (read a word at a time; at 6
    bits, with B % 4 == 0, every row is whole uint4s) and scale blocks other
    than 16, 32 and 64 (a run of 4 * cpw codes meeting more than two of
    them, or blocks of a non-power-of-two size)."""
    _need_cuda()
    cpw = 32 // bits
    rs = np.random.RandomState(bits + block)
    bk = cpw * block // np.gcd(cpw, block)
    Ks = [K for K in range(bk, 40 * bk, bk) if (K // cpw) % 4][:2] or [bk, 3 * bk]
    assert bits == 6 or all((K // cpw) % 4 for K in Ks), (bits, block)
    for K in Ks:
        _gemv_tc_matches_plain(_b1(bits, "float", block, K, 70, rs), (1, 4, 8), rs)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block", [(3, 6), (3, 10), (4, 12), (4, 20), (5, 6), (5, 10),
                                        (6, 6), (6, 10), (7, 6), (8, 10)])
def test_cuda_core_gemv_bf16_at_blocks_that_split_a_group(bits, block):
    """bf16 x whose scale blocks split a group of 4 codes (at 4 bits a word)
    goes to qmatmul.cu's GEMV, which reads the rows as stored: one launch
    of it and none of the tensor-core GEMV, every row count to 8, within
    one bf16 ulp at max|y| of the plain version."""
    _need_cuda()
    assert tqm.gemv_route(torch.bfloat16, bits, block) == "simt"
    rs = np.random.RandomState(bits * 31 + block)
    for dtype in ("int", "float", "dynamic"):
        for K, N in ((200, 70), (1000, 17)):
            op = _b1(bits, dtype, block, K, N, rs)
            for M in (1, 2, 3, 5, 8):
                x = torch.tensor(rs.randn(M, op.k_dim), device="cuda").to(torch.bfloat16)
                xp, packed, scales = tops.pad_for_kernel(x, op)
                kw = dict(bits=bits, block_size=block)
                before = (tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemv_simt.launches)
                y_k = tqm.qmatmul_gemv(xp, packed, scales, op.codebook, **kw).float()
                y_p = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw).float()
                torch.cuda.synchronize()
                assert (tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemv_simt.launches) == \
                    (before[0], before[1] + 1)
                err = float((y_k - y_p).abs().max())
                assert err <= BF16_REL_TOL * float(y_p.abs().max()), (M, K, N, dtype)


def _gemv_f32_matches_plain(op, Ms, rs):
    """Each row count through qmatmul_gemv with f32 x: one launch of
    qmatmul.cu's GEMV (gemv_route's "simt") on the operands as stored, none
    of the tensor-core GEMV, within 2e-5 relative of the plain version."""
    for M in Ms:
        x = torch.tensor(rs.randn(M, op.k_dim), dtype=torch.float32, device="cuda")
        xp, packed, scales = tops.pad_for_kernel(x, op)
        assert packed.data_ptr() == op.packed.data_ptr()
        kw = dict(bits=op.bits, block_size=op.block_size)
        before = (tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemv_simt.launches)
        y_k = tqm.qmatmul_gemv(xp, packed, scales, op.codebook, **kw)
        y_p = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw)
        torch.cuda.synchronize()
        assert (tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemv_simt.launches) == \
            (before[0], before[1] + 1)
        assert y_k.dtype == torch.float32 and bool(torch.isfinite(y_k).all())
        err = float((y_k - y_p).abs().max())
        assert err <= F32_REL_TOL * float(y_p.abs().max()), (M, op.k_dim, packed.shape, op.bits)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 32, 64, 6, 10, 12, 20])
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_gemv_f32_matches_plain(bits, block):
    """f32 x at every width and row count to 8, rows as stored: K tails off
    whole words, scale blocks of whole groups (the scale factored out of a
    group's products) and blocks that groups or words straddle, and x rows
    off 16 bytes (K = 1002 at block 6)."""
    _need_cuda()
    rs = np.random.RandomState(bits * 37 + block)
    for dtype in ("int", "float", "dynamic"):
        _gemv_f32_matches_plain(_b1(bits, dtype, block, 200, 70, rs), range(1, 9), rs)
    _gemv_f32_matches_plain(_b1(bits, "float", block, 1000, 17, rs), (1, 3, 8), rs)


@pytest.mark.cuda
def test_gemv_f32_at_the_bench_and_qwen2_7b_shapes():
    """kernel_bench's four weights (M, K, N = 8, 2048, 2048 at int3, int4,
    float4 and int8, block 64) and Qwen2-7B's matrix shapes with the
    lm_head (4-bit float, block 64) at 1, 4 and 8 rows."""
    _need_cuda()
    from repro_torch.paper import kernel_bench as kb

    rs = np.random.RandomState(11)
    for bits, dtype in kb.TAGS:
        _gemv_f32_matches_plain(_b1(bits, dtype, 64, kb.K, kb.N, rs), (1, 4, kb.M), rs)
    cfg = get_arch("qwen2-7b")
    D, F, KD = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim
    for K, N in ((D, D), (D, KD), (D, F), (F, D), (D, cfg.vocab_size)):
        _gemv_f32_matches_plain(_b1(4, "float", 64, K, N, rs), (1, 4, 8), rs)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,block", [(4, "float", 64), (3, "int", 64), (8, "int", 64),
                                              (5, "dynamic", 6), (6, "int", 20)])
def test_gemv_f32_row_does_not_depend_on_the_rows_beside_it(bits, dtype, block):
    """Row r of an 8-row call equals the same row called alone, bit for bit:
    the block's K split and the order of its sums depend on N and K only."""
    _need_cuda()
    rs = np.random.RandomState(bits + block)
    for K, N in ((3584, 512), (2048, 2048), (200, 70)):
        op = _b1(bits, dtype, block, K, N, rs)
        x = torch.tensor(rs.randn(8, op.k_dim), dtype=torch.float32, device="cuda")
        kw = dict(bits=bits, block_size=block)
        y8 = tqm.qmatmul_gemv_simt(x, op.packed, op.scales, op.codebook, **kw)
        for r in (0, 3, 7):
            y1 = tqm.qmatmul_gemv_simt(x[r:r + 1].contiguous(), op.packed, op.scales,
                                       op.codebook, **kw)
            torch.cuda.synchronize()
            assert torch.equal(y8[r:r + 1], y1), (K, N, r)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 5, 6])
def test_prefill_gemm_takes_rows_as_stored(bits):
    """The bf16 prefill GEMM's launcher given rows as stored, ceil(K / cpw)
    words (Qwen2-7B's K of 3584, a K tail, and a K off the kernel's pieces
    of 8), which it pads to whole words itself: within one bf16 ulp at
    max|y| of the plain version on the stored rows."""
    _need_cuda()
    rs = np.random.RandomState(bits + 40)
    for M, K, N, block in ((1024, 3584, 512, 64), (130, 200, 136, 16), (9, 90, 70, 6)):
        op = _b1(bits, "float", block, K, N, rs)
        assert op.packed.shape[1] == -(-op.k_dim // (32 // bits))
        x = torch.tensor(rs.randn(M, op.k_dim), device="cuda").to(torch.bfloat16)
        xp, packed, scales = tops.pad_for_kernel(x, op)
        assert packed.data_ptr() == op.packed.data_ptr()
        kw = dict(bits=bits, block_size=block)
        before = (tqm.qmatmul_gemm.launches, tqm.qmatmul_gemm.simt_launches)
        y_k = tqm.qmatmul_gemm(xp, packed, scales, op.codebook, **kw).float()
        y_p = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw).float()
        torch.cuda.synchronize()
        assert (tqm.qmatmul_gemm.launches, tqm.qmatmul_gemm.simt_launches) == \
            (before[0] + 1, before[1])
        err = float((y_k - y_p).abs().max())
        assert err <= BF16_REL_TOL * float(y_p.abs().max()), (M, K, N, block)


def _gemm_f32_matches_plain(op, M, rs):
    x = torch.tensor(rs.randn(M, op.k_dim), dtype=torch.float32, device="cuda")
    xp, packed, scales = tops.pad_for_kernel(x, op)
    kw = dict(bits=op.bits, block_size=op.block_size)
    before = tqm.qmatmul_gemm.simt_launches
    y_k = tqm.qmatmul_gemm(xp, packed, scales, op.codebook, **kw)
    y_p = tqm.qmatmul_plain(xp, packed, scales, op.codebook, **kw)
    torch.cuda.synchronize()
    assert tqm.qmatmul_gemm.simt_launches == before + 1
    err = float((y_k - y_p).abs().max())
    assert err <= F32_REL_TOL * float(y_p.abs().max()), (M, op.k_dim, packed.shape, op.bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_gemm_f32_matches_plain(bits):
    """The paper ladder's matrices at its perplexity batch (M = 1024), which
    the K split reaches, then ragged rows, columns and K with blocks that
    words straddle."""
    _need_cuda()
    from repro_torch.configs.tiny import TINY_FAMILY

    rs = np.random.RandomState(bits)
    for tcfg in TINY_FAMILY.values():
        D, F = tcfg.d_model, tcfg.d_ff
        for K, N in ((D, D), (D, F), (F, D)):
            _gemm_f32_matches_plain(_b1(bits, "float", 64, K, N, rs), 1024, rs)
    for M, K, N, block in ((9, 200, 70, 16), (130, 640, 136, 6), (257, 1000, 8, 20),
                           (1000, 3584, 512, 32), (33, 96, 65, 12)):
        _gemm_f32_matches_plain(_b1(bits, "int", block, K, N, rs), M, rs)


@pytest.mark.cuda
def test_gemm_f32_rows_do_not_depend_on_the_call():
    """A row's sums take the same order whether it is computed alone or
    among 1024 rows: the K split depends on N and K only."""
    _need_cuda()
    rs = np.random.RandomState(5)
    for K, N in ((448, 1344), (1344, 448), (64, 64), (200, 70)):
        op = _b1(4, "float", 64, K, N, rs)
        x = torch.tensor(rs.randn(1024, op.k_dim), dtype=torch.float32, device="cuda")
        xp, packed, scales = tops.pad_for_kernel(x, op)
        kw = dict(bits=4, block_size=64)
        big = tqm.qmatmul_gemm(xp, packed, scales, op.codebook, **kw)
        for lo, hi in ((0, 9), (100, 357), (1000, 1024)):
            alone = tqm.qmatmul_gemm(xp[lo:hi].contiguous(), packed, scales, op.codebook, **kw)
            assert torch.equal(alone, big[lo:hi]), (K, N, lo, hi)


# ---------------------------------------------------------------------------
# the routed read of a packed cache (kernels/kv_attention.fused_takes says
# the fused kernel does not take the shapes), the KV dequant that carries
# it, and the flat encode (csrc/quantize.cu)
# ---------------------------------------------------------------------------

def _routed_case(bits, B, S, K, G, Dh, seed):
    """A packed cache on the card whose rows have their own lengths (empty
    slots past them and 10 % holes), q, and [B] positions, row 1 idle."""
    rs = np.random.RandomState(seed)
    spec = tkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
    cache = {}
    for name in ("k", "v"):
        x = torch.tensor(rs.randn(B, S, K * Dh), dtype=torch.bfloat16, device="cuda")
        cache[f"{name}_packed"], cache[f"{name}_scales"] = tkv.encode_rows(x, spec)
    lens = rs.randint(S // 2, S + 1, B)
    ar = np.arange(S)
    pos_arr = np.stack([np.where(ar < n, ar, -1) for n in lens])
    pos_arr[rs.rand(B, S) < 0.1] = -1
    cache["pos"] = torch.from_numpy(pos_arr.astype(np.int32)).cuda()
    pos = torch.from_numpy((lens - 1).astype(np.int32)).cuda()
    if B > 1:
        pos[1] = -1
    q = torch.tensor(rs.randn(B, K * G, Dh) * 2, dtype=torch.bfloat16, device="cuda")
    return q, cache, pos, spec


def _to_pages(cache, ps, seed):
    """The [B, S] rows of a cache in pages of ps under a shuffled page map,
    the trash page 0 empty."""
    B, S = cache["pos"].shape
    P = S // ps
    ids = np.random.RandomState(seed).permutation(np.arange(1, B * P + 2))[: B * P]
    page_map = torch.from_numpy(ids.reshape(B, P).astype(np.int32)).cuda()
    out = {}
    for key, leaf in cache.items():
        pages = torch.zeros((B * P + 2, ps) + tuple(leaf.shape[2:]), dtype=leaf.dtype,
                            device="cuda")
        if key == "pos":
            pages.fill_(-1)
        pages[page_map.reshape(-1).long()] = leaf.reshape((B * P, ps) + tuple(leaf.shape[2:]))
        out[key] = pages
    return out, page_map


@pytest.mark.cuda
@pytest.mark.parametrize("bits,B,S,K,G,Dh", [
    (4, 4, 304, 8, 1, 56), (8, 4, 304, 8, 1, 56),       # tiny-10m's heads
    (4, 3, 288, 8, 4, 120), (8, 2, 160, 2, 8, 120),      # h2o-danube-3-4b's head dim, G 4 and 8
    (4, 1, 40960, 4, 7, 128)])                          # Qwen2-7B's heads, past the kernel
def test_routed_read_matches_plain(bits, B, S, K, G, Dh):
    """decode_attention_packed takes the routed read (one KV dequant launch,
    no fused attention), within 2^-6 of each row's max of the plain version,
    idle rows exactly 0; the same cache in pages of 16 gives the rows' result
    bit for bit; the fused kernel's wrapper raises before any launch."""
    _need_cuda()
    q, cache, pos, spec = _routed_case(bits, B, S, K, G, Dh, seed=bits + S + Dh)
    assert not tka.fused_takes(B, K * G, Dh, S, spec, K * Dh)
    before = launches.snapshot()
    attn0, kv0 = tka.decode_attention_packed_cuda.launches, tkv.dequant_kv_cuda.launches
    out = tka.decode_attention_packed(q, cache, pos, spec)
    assert tka.decode_attention_packed_cuda.launches == attn0
    assert tkv.dequant_kv_cuda.launches == kv0 + 1
    plain = tka.decode_attention_packed_plain(q, cache, pos, spec).float()
    torch.cuda.synchronize()
    gap = (out.float() - plain).abs().amax(-1)
    assert bool(torch.isfinite(out).all())
    assert bool((gap <= ATT_TOL * plain.abs().amax(-1)).all()), float(gap.max())
    if B > 1:
        assert not bool(out[1].abs().any()) and not bool(plain[1].abs().any())
    paged, page_map = _to_pages(cache, 16, seed=S)
    out_p = tka.decode_attention_packed(q, paged, pos, spec, page_map=page_map, page_size=16)
    torch.cuda.synchronize()
    assert torch.equal(out_p.view(torch.int16), out.view(torch.int16))
    launched = launches.snapshot()
    with pytest.raises(ValueError, match="decode_attention_packed_cuda"):
        tka.decode_attention_packed_cuda(q, cache, pos, spec)
    with pytest.raises(ValueError, match="decode_attention_packed_cuda"):
        tka.decode_attention_packed_cuda(q, paged, pos, spec, page_map=page_map, page_size=16)
    assert launches.snapshot() == launched
    assert sum(launches.snapshot()) - sum(before) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("feat,block", [(448, 64), (960, 64), (48, 6), (40, 8), (512, 32)])
def test_kv_dequant_kernel_bit_exact_rows_pages_and_kv(bits, feat, block):
    """The KV dequant kernel against dequant_rows_ref: one leaf of 37 rows,
    K and V of [3, 37] rows in one launch, and K and V of pages of 8
    through a shuffled page map (3 rows of 5 pages, a page shared), bit for
    bit.  The feature widths give 1, 2 and 4 words a thread, and blocks of 6
    split words."""
    _need_cuda()
    if feat % (32 // bits):
        pytest.skip(f"{feat} features do not fill {bits}-bit words")
    spec = tkv.KVQuantSpec(bits=bits, block_size=block, dtype_name="float")
    rs = np.random.RandomState(bits + feat + block)

    def leaf(*lead):
        x = torch.tensor(rs.randn(*lead, feat) * rs.lognormal(0, 1, lead + (1,)),
                         dtype=torch.bfloat16, device="cuda")
        return tkv.encode_rows(x, spec)

    def same(a, b):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))

    p, s = leaf(37)
    assert same(tkv.dequant_rows_cuda(p, s, spec, feat), tkv.dequant_rows_ref(p, s, spec, feat))
    (kp, ks), (vp, vs) = leaf(3, 37), leaf(3, 37)
    before = tkv.dequant_kv_cuda.launches
    k, v = tkv.dequant_kv_cuda([(kp, ks), (vp, vs)], spec, feat)
    assert tkv.dequant_kv_cuda.launches == before + 1
    assert same(k, tkv.dequant_rows_ref(kp, ks, spec, feat))
    assert same(v, tkv.dequant_rows_ref(vp, vs, spec, feat))
    (kp, ks), (vp, vs) = leaf(17, 8), leaf(17, 8)
    page_map = torch.from_numpy(rs.permutation(np.arange(1, 17))[:15].reshape(3, 5)
                                .astype(np.int32)).cuda()
    page_map[2, 0] = page_map[0, 0]
    cache = {"k_packed": kp, "k_scales": ks, "v_packed": vp, "v_scales": vs}
    k, v = tkv.dequant_kv(cache, spec, feat, page_map)
    kr, vr = tkv.dequant_kv_plain(cache, spec, feat, page_map)
    assert tuple(k.shape) == (3, 40, feat) and same(k, kr) and same(v, vr)
    assert same(tkv.dequant_pages(kp, ks, page_map, spec, feat), kr)


def _encode_cases(cb: np.ndarray, block: int, rs) -> np.ndarray:
    """Blocks [n, block] whose absmax is a power of two s and whose other
    values are the codebook's values and midpoints times s (x / s hits them
    exactly), blocks of +0, of -0 and of subnormals, blocks mixing ±0 and
    subnormals with a normal value, then random blocks of mixed scale."""
    special = np.concatenate([cb, (cb[:-1] + cb[1:]) / np.float32(2.0)]).astype(np.float32)
    special = np.concatenate([special, -special])
    rows = []
    if block == 1:
        rows += [[v] for v in special]
    else:
        for i in range(0, special.size, block - 1):
            s = np.float32(2.0 ** rs.randint(-6, 3))
            blk = np.concatenate([[np.float32(1.0)], special[i: i + block - 1]]) * s
            rows.append(np.pad(blk, (0, block - blk.size)))
    tiny = np.float32(1e-40) * np.arange(1, block + 1, dtype=np.float32)
    rows += [np.zeros(block, np.float32), -np.zeros(block, np.float32), tiny, -tiny,
             np.where(np.arange(block) % 2, -np.float32(0.0), tiny)]
    mixed = np.where(np.arange(block) % 3 == 0, -np.float32(0.0), tiny)
    mixed[-1] = np.float32(0.75)
    rows.append(mixed)
    n_rand = max(8, 4096 // block)
    rows += list((rs.randn(n_rand, block) * rs.lognormal(0, 2, (n_rand, 1))).astype(np.float32))
    return np.stack(rows).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_quantize_blocks_cuda_bit_exact_over_blocks(bits):
    """The flat encode against its plain version, codes and scale bits,
    over blocks that take its vector body (32 to 1024, and 100: a group of
    25 lanes in 32) and its one-warp body (1, 3 and 2048), a codebook of
    each data type, on values at the codebook's points and midpoints, ±0
    and subnormals; and x off 16 bytes (the one-warp body again)."""
    _need_cuda()
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import quantize as tquant

    rs = np.random.RandomState(bits)
    before = tquant.quantize_blocks_cuda.launches
    n = 0
    for dtype in ("int", "float", "dynamic", "quantile"):
        base = torch.tensor(rs.standard_t(4, 4096).astype(np.float32), device="cuda")
        cb = make_codebook(dtype, bits, tensor=base)
        for block in (1, 3, 32, 64, 100, 128, 256, 1024, 2048):
            xb = torch.from_numpy(_encode_cases(cb.cpu().numpy(), block, rs)).cuda()
            for x in (xb, torch.cat([torch.zeros(1, device="cuda"), xb.reshape(-1)])[1:]
                      .reshape(xb.shape)):
                kc, ks = tquant.quantize_blocks_cuda(x, cb)
                pc, ps = tquant.quantize_blocks_plain(x, cb)
                torch.cuda.synchronize()
                assert torch.equal(kc, pc), (dtype, block, x.data_ptr() % 16)
                assert torch.equal(ks.view(torch.int32), ps.view(torch.int32)), (dtype, block)
                n += 1
    assert tquant.quantize_blocks_cuda.launches == before + n


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [4, 8])
def test_tiny_10m_decodes_from_a_packed_cache(kv):
    """tiny-10m (head dim 56) at kv4 and kv8: the Engine's captured steps
    give its eager steps' tokens, each step one KV dequant launch a layer
    and no fused attention, counted at each replay; the Server on slots and
    on pages of 16 streams the same tokens for every request."""
    _need_cuda()
    cfg = get_arch("tiny-10m").with_kv_quant(kv)
    params = _q4_params(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(kv))
    n = 16
    attn0, kv0 = tka.decode_attention_packed_cuda.launches, tkv.dequant_kv_cuda.launches
    graph = Engine(params, cfg, max_seq_len=16 + n, device="cuda").generate(prompts, n)
    torch.cuda.synchronize()
    assert tka.decode_attention_packed_cuda.launches == attn0
    # the capture's warm-up step and n - 1 replays, a launch a layer each
    assert tkv.dequant_kv_cuda.launches - kv0 == n * cfg.n_layers
    assert torch.equal(graph, _eager(params, cfg, prompts, n, 0.0, None, 16 + n))
    rs = np.random.RandomState(kv)
    reqs = [rs.randint(0, cfg.vocab_size, L) for L in (40, 100, 23, 70)]

    def serve(**kw):
        srv = Server(params, cfg, num_slots=3, max_seq_len=256, device="cuda", **kw)
        ids = [srv.submit(p, 12, arrival_time=float(i)) for i, p in enumerate(reqs)]
        res = srv.run_until_drained()
        return [res[i] for i in ids]

    slot = serve()
    assert [len(t) for t in slot] == [12] * len(reqs)
    assert serve(paged=True, page_size=16) == slot
    assert tka.decode_attention_packed_cuda.launches == attn0


# ---------------------------------------------------------------------------
# the paper's remaining experiments: centered and proxy-quantized encodes
# (fig4, appb) and GPTQ on the card (table1)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 128, 1024])
def test_centered_flat_encode_bit_exact(block):
    """The centered encode on the card: the block means bit-equal to the
    CPU's (``mean_xla`` adds in a fixed order on either device), the codes
    and scales of the flat encode kernel bit-exact to the plain encode of
    the same centered blocks, one launch."""
    _need_cuda()
    from repro_torch.core import blockwise
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import quantize as tquant

    rs = np.random.RandomState(block)
    x = (rs.randn(300, block) * 0.02 + rs.randn(300, 1) * 0.01).astype(np.float32)
    cb = make_codebook("int", 4, device="cuda")
    before = tquant.quantize_blocks_cuda.launches
    card = blockwise.encode(torch.from_numpy(x).cuda(), cb, block, centering=True)
    assert tquant.quantize_blocks_cuda.launches == before + 1
    mean_card = blockwise.mean_xla(torch.from_numpy(x).cuda(), 1)
    mean_cpu = blockwise.mean_xla(torch.from_numpy(x), 1)
    assert torch.equal(mean_card.cpu().view(torch.int32), mean_cpu.view(torch.int32))
    centered = torch.from_numpy(x).cuda() - mean_card[:, None]
    pc, ps = tquant.quantize_blocks_plain(centered.cpu(), cb.cpu())
    assert torch.equal(card.codes.cpu().to(torch.int32), pc)
    assert torch.equal(card.scales.cpu().view(torch.int16),
                       ps.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(card.means.cpu().view(torch.int16),
                       mean_cpu.to(torch.bfloat16).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 4])
def test_proxy_quantize_pack_on_zeroed_transposed_items(bits):
    """A transposed-stored weight [L, In, Out] with 2 % of its input dims
    as outliers: one quantize_pack launch an item, reading the zeroed copy
    through its transpose, every field bit-identical to the CPU encode."""
    _need_cuda()
    from repro_torch.core import proxy
    from repro_torch.kernels import quantize as tquant
    from repro_torch.models.quantize import _quantize_matrix

    rs = np.random.RandomState(bits)
    w = torch.tensor(rs.randn(3, 448, 1344) * 0.02, dtype=torch.float32)
    idx = proxy.outlier_indices_topk(proxy.std_xla(w, -1), 9)        # [3, 9] input dims
    qcfg = QuantConfig(bits=bits, dtype="float", block_size=64, outlier_pct=0.02)
    before = tquant.quantize_pack_cuda.launches
    card = _quantize_matrix(w.cuda(), qcfg, outlier_idx=idx.cuda())
    assert tquant.quantize_pack_cuda.launches == before + 3
    cpu = _quantize_matrix(w, qcfg, outlier_idx=idx)
    for f in ("packed", "scales", "outlier_vals", "outlier_idx"):
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block", [(2, 64), (3, None)])
def test_gptq_on_the_card_matches_the_cpu(bits, block):
    """core/gptq.py in float64 on the card against the same on the CPU:
    within 1e-12 relative."""
    _need_cuda()
    from repro_torch.core import gptq
    from repro_torch.core.codebooks import make_codebook

    rs = np.random.RandomState(bits)
    w = torch.tensor(rs.randn(128, 128) * 0.05, dtype=torch.float32)
    x = torch.tensor(rs.randn(512, 128), dtype=torch.float32)
    x[:, 7] = 0.0
    cb = make_codebook("int", bits, device="cpu")
    cpu = gptq.gptq_quantize(w, gptq.hessian_from_inputs(x), cb, block_size=block)
    card = gptq.gptq_quantize(w.cuda(), gptq.hessian_from_inputs(x.cuda()), cb.cuda(),
                              block_size=block)
    assert card.device.type == "cuda" and card.dtype == torch.float64
    rel = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    assert rel <= 1e-12, rel


# ---------------------------------------------------------------------------
# mixed-precision plans
# ---------------------------------------------------------------------------

def _cycle_plan(cfg, cycle):
    """A plan giving the tree's units the widths of ``cycle`` in turn."""
    import dataclasses

    from repro_torch.models.quantize import quantizable_units
    from repro_torch.precision import PrecisionPlan

    units = sorted(quantizable_units(lm.init_params(cfg, device="meta"), cfg))
    return PrecisionPlan(arch=cfg.name, default=dataclasses.asdict(QuantConfig(bits=4)),
                         assignments={u: {"bits": cycle[i % len(cycle)]}
                                      for i, u in enumerate(units)})


@pytest.mark.cuda
def test_plan_quantized_tree_on_the_card_equals_the_cpu():
    """quantize_tree(plan=) over every candidate width and a dense unit: the
    same packed words and bf16 scales on the card as on the CPU."""
    _need_cuda()
    from repro_torch.interop import flatten
    from repro_torch.models.quantize import quantize_tree

    cfg = get_arch("tiny-650k")
    plan = _cycle_plan(cfg, (3, 4, 5, 6, 8, 16))
    raw = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    cpu = flatten(quantize_tree(raw, cfg, plan=plan, device="cpu"))
    card = flatten(quantize_tree(raw, cfg, plan=plan, device="cuda"))
    assert cpu.keys() == card.keys()
    for k, v in cpu.items():
        w = card[k].cpu()
        assert v.dtype == w.dtype and v.shape == w.shape, k
        if v.dtype == torch.bfloat16:
            v, w = v.view(torch.int16), w.view(torch.int16)
        assert torch.equal(v, w), k


@pytest.mark.cuda
def test_engine_plan_replay_equals_eager():
    """Engine(plan=) quantizes at load on the card; its captured steps give
    the eager steps' tokens."""
    _need_cuda()
    cfg = get_arch("tiny-650k").with_kv_quant(4)
    plan = _cycle_plan(cfg, (3, 5, 6, 8, 16, 4))
    raw = lm.init_params(cfg, seed=1, device="cuda", dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (3, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
    eng = Engine(raw, cfg, max_seq_len=40, plan=plan, device="cuda")
    graph = eng.generate(prompts, 24)
    assert torch.equal(graph, _eager(eng.params, cfg, prompts, 24, 0.0, None, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [False, True])
def test_server_plan_3_5_6_equals_batch1_engine(probe):
    """The Server under a plan of 3-, 5- and 6-bit units streams each
    request's batch-1 Engine tokens; with the kv probe on it streams the
    same tokens and records a finite roundtrip error above 0."""
    _need_cuda()
    cfg = get_arch("tiny-650k").with_kv_quant(4)
    plan = _cycle_plan(cfg, (3, 5, 6))
    raw = lm.init_params(cfg, seed=2, device="cuda", dtype=torch.bfloat16)
    rs = np.random.RandomState(7)
    reqs = [rs.randint(0, cfg.vocab_size, L) for L in (12, 30, 7, 21, 16)]
    eng = Engine(raw, cfg, max_seq_len=64, plan=plan, device="cuda")
    ref = [eng.generate(torch.as_tensor(p, device="cuda")[None], 10)[0].tolist() for p in reqs]
    tel = Telemetry(kv_probe_every=1) if probe else Telemetry()
    srv = Server(raw, cfg, num_slots=3, max_seq_len=64, plan=plan, telemetry=tel, device="cuda")
    ids = [srv.submit(p, 10, arrival_time=0.5 * i) for i, p in enumerate(reqs)]
    res = srv.run_until_drained()
    assert [res[i] for i in ids] == ref
    d = tel.registry.as_dict()
    if probe:
        qmax = d["kv_append_qerr_max"][""]["value"]
        assert np.isfinite(qmax) and qmax > 0
        assert d["kv_probe_rows_total"][""] >= sum(len(p) for p in reqs)
    else:
        assert "kv_append_qerr_max" not in d


# ---------------------------------------------------------------------------
# sliding windows: the routed read over a wrapped ring, captured ring steps
# ---------------------------------------------------------------------------

def _ring_case(bits, K, G, Dh, S, ends, seed):
    """A packed ring of S slots a row on the card: row b holds positions up to
    ends[b], each at slot p % S (the latest S of them; unwritten slots -1),
    rows at ends[b] < 0 idle; q and the [B] positions."""
    rs = np.random.RandomState(seed)
    B = len(ends)
    spec = tkv.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
    cache = {}
    for name in ("k", "v"):
        x = torch.tensor(rs.randn(B, S, K * Dh), dtype=torch.bfloat16, device="cuda")
        cache[f"{name}_packed"], cache[f"{name}_scales"] = tkv.encode_rows(x, spec)
    end = np.asarray(ends)[:, None]
    slot = np.arange(S)[None, :]
    pos_arr = end - ((end - slot) % S)
    pos_arr = np.where((pos_arr >= 0) & (end >= 0), pos_arr, -1).astype(np.int32)
    cache["pos"] = torch.from_numpy(pos_arr).cuda()
    q = torch.tensor(rs.randn(B, K * G, Dh) * 2, dtype=torch.bfloat16, device="cuda")
    return q, cache, torch.tensor(ends, dtype=torch.int32, device="cuda"), spec


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,G,Dh,cap", [(8, 4, 120, 0.0), (16, 2, 128, 50.0)])
def test_routed_read_over_a_wrapped_ring(bits, K, G, Dh, cap):
    """h2o-danube-3-4b's heads (Dh 120) and gemma2-27b's local layers' (Dh
    128, soft-cap 50) over a 4096-slot ring and window: per-row positions
    past the ring (slot order is not position order), one not yet wrapped
    and an idle row.  The routed read (one KV dequant launch, no fused
    attention, whose wrapper raises on a window) within 2^-6 of each row's
    max of the plain version, the idle row exactly 0."""
    _need_cuda()
    S = 4096
    q, cache, pos, spec = _ring_case(bits, K, G, Dh, S, [S + 37, -1, S // 2, 2 * S + 5],
                                     seed=bits + Dh)
    assert not tka.fused_takes(4, K * G, Dh, S, spec, K * Dh, window=S)
    attn0, kv0 = tka.decode_attention_packed_cuda.launches, tkv.dequant_kv_cuda.launches
    out = tka.decode_attention_packed(q, cache, pos, spec, cap=cap, window=S)
    plain = tka.decode_attention_packed_plain(q, cache, pos, spec, cap=cap, window=S).float()
    torch.cuda.synchronize()
    assert tka.decode_attention_packed_cuda.launches == attn0
    assert tkv.dequant_kv_cuda.launches == kv0 + 1
    gap = (out.float() - plain).abs().amax(-1)
    assert bool(torch.isfinite(out).all())
    assert bool((gap <= ATT_TOL * plain.abs().amax(-1)).all()), float(gap.max())
    assert not bool(out[1].abs().any()) and not bool(plain[1].abs().any())
    with pytest.raises(ValueError, match="sliding window"):
        tka.decode_attention_packed_cuda(q, cache, pos, spec, cap=cap, window=S)
    assert tka.decode_attention_packed_cuda.launches == attn0


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [16, 8, 4])
@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "gemma2-27b"])
def test_ring_engine_graph_tokens_equal_eager(name, kv):
    """reduced() danube and gemma2 (rings of 16 beside gemma2's global
    caches): a prompt longer than the ring, then decode steps that wrap it
    again; the captured steps' tokens equal eager steps', one KV dequant a
    windowed layer and step at kv4/kv8 (and a global layer, whose head dim
    of 16 the fused attention does not take)."""
    _need_cuda()
    cfg = get_arch(name).reduced().with_kv_quant(kv)
    params = _q4_params(cfg)
    S, n = 20, 24
    prompts = torch.randint(0, cfg.vocab_size, (2, S), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(kv))
    attn0, kv0 = tka.decode_attention_packed_cuda.launches, tkv.dequant_kv_cuda.launches
    graph = Engine(params, cfg, max_seq_len=S + n, device="cuda").generate(prompts, n)
    torch.cuda.synchronize()
    n_local = cfg.n_layers if name.startswith("h2o") else cfg.n_layers // 2
    n_global = cfg.n_layers - n_local
    fused = kv < 16 and tka.fused_takes(2, cfg.n_heads, cfg.head_dim, S + n, tkv.kv_spec(cfg),
                                        cfg.n_kv_heads * cfg.head_dim)
    # every windowed layer reads through the KV dequant; a global one through
    # the fused kernel where it takes the shapes (not reduced()'s Dh 16)
    routed = 0 if kv == 16 else n_local + (0 if fused else n_global)
    assert tkv.dequant_kv_cuda.launches - kv0 == n * routed
    assert tka.decode_attention_packed_cuda.launches - attn0 == (n * n_global if fused else 0)
    assert torch.equal(graph, _eager(params, cfg, prompts, n, 0.0, None, S + n))


@pytest.mark.cuda
def test_ring_server_equals_engine_and_refuses_pages():
    """reduced() danube at kv4 on a pool of rings: the Server's tokens equal
    the per-request Engine's (exact-length prefills, prompts over the ring),
    and paged serving and chunked prefill are refused."""
    _need_cuda()
    cfg = get_arch("h2o-danube-3-4b").reduced().with_kv_quant(4)
    params = _q4_params(cfg)
    rs = np.random.RandomState(3)
    reqs = [rs.randint(0, cfg.vocab_size, L) for L in (27, 9, 18, 5)]
    srv = Server(params, cfg, num_slots=2, max_seq_len=48, device="cuda")
    ids = [srv.submit(p, 14, arrival_time=float(i)) for i, p in enumerate(reqs)]
    res = srv.run_until_drained()
    for i, p in zip(ids, reqs):
        eng = Engine(params, cfg, max_seq_len=48, device="cuda").generate(
            torch.as_tensor(p, device="cuda")[None], 14)
        assert res[i] == eng[0].tolist(), i
    for kw in ({"paged": True}, {"prefill_chunk": 128}):
        with pytest.raises(ValueError):
            Server(params, cfg, num_slots=2, max_seq_len=48, device="cuda", **kw)


@pytest.mark.cuda
def test_wide_dense_head_in_column_pieces():
    """A dense weight of more rows than ``layers.COL_PIECE`` (gemma2's tied
    head) multiplies in column pieces of one shape: a row's logits equal
    alone and among 8 rows bit for bit, and an f32 product of the whole
    weight within f32 summation order."""
    _need_cuda()
    from repro_torch.models import layers

    N, K = 2 * layers.COL_PIECE + 77, 256
    g = torch.Generator("cuda").manual_seed(5)
    w = torch.randn((N, K), generator=g, device="cuda").to(torch.bfloat16)
    x = torch.randn((8, K), generator=g, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        y8 = layers.matmul_rounded(x, w)
        y1 = layers.matmul_rounded(x[:1], w)
    ref = (x.float() @ w.float().T)
    torch.cuda.synchronize()
    assert y8.shape == (8, N) and y8.dtype == torch.bfloat16
    assert torch.equal(y8[:1].view(torch.int16), y1.view(torch.int16))
    assert float((y8.float() - ref).abs().max()) <= BF16_REL_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_routed_read_row_does_not_depend_on_the_batch():
    """The routed read's partials go a row at a time on the card, so a row
    of a 4-row pool read equals the same row read alone bit for bit (the
    Server against the batch-1 Engine on windowed archs)."""
    _need_cuda()
    S = 4096
    q, cache, pos, spec = _ring_case(4, 8, 4, 120, S, [S + 37, -1, S // 2, 2 * S + 5], seed=9)
    out = tka.decode_attention_packed(q, cache, pos, spec, window=S)
    for b in range(4):
        one = {k: v[b:b + 1].contiguous() for k, v in cache.items()}
        alone = tka.decode_attention_packed(q[b:b + 1].contiguous(), one, pos[b:b + 1], spec,
                                            window=S)
        torch.cuda.synchronize()
        assert torch.equal(alone.view(torch.int16), out[b:b + 1].view(torch.int16)), b


def _experts_case(bits, block, N, K, counts, rs):
    """E = len(counts) experts' words, scales and codebooks from
    ``prepare_operand``, x [E, 8, K] in a buffer of 9 rows an expert (the
    MoE path's capacity buffers hold an overflow row), 16 where 9 rows are
    not whole 16 bytes."""
    ops_ = [_b1(bits, "float", block, K, N, rs) for _ in counts]
    packed = torch.stack([o.packed for o in ops_])
    scales = torch.stack([o.scales for o in ops_])
    cb = torch.stack([o.codebook for o in ops_])
    E, M = len(counts), tqm.GEMV_MAX_M
    K = ops_[0].k_dim
    buf = torch.tensor(rs.randn(E, 9 if K % 8 == 0 else 16, K), device="cuda").to(torch.bfloat16)
    x = buf[:, :M]
    return x, packed, scales, cb, torch.tensor(counts, dtype=torch.int32, device="cuda")


def _experts_bit_identical(x, packed, scales, cb, counts, bits, block):
    kw = dict(bits=bits, block_size=block)
    before = tqm.qmatmul_gemv_experts.launches
    y = tqm.qmatmul_gemv_experts(x, packed, scales, cb, counts, **kw)
    plain = tqm.qmatmul_experts_plain(x, packed, scales, cb, counts, **kw)
    torch.cuda.synchronize()
    assert tqm.qmatmul_gemv_experts.launches == before + 1
    for e, c in enumerate(counts.tolist()):
        if not c:
            continue
        one = tqm.qmatmul_gemv_tc(x[e, :c].contiguous(), packed[e], scales[e], cb[e], **kw)
        torch.cuda.synchronize()
        assert torch.equal(y[e, :c].view(torch.int16), one.view(torch.int16)), (e, c)
        err = float((y[e, :c].float() - plain[e, :c].float()).abs().max())
        assert err <= BF16_REL_TOL * float(plain[e, :c].float().abs().max()), (e, c, err)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block", [(3, 4), (3, 64), (4, 8), (4, 64), (5, 12), (5, 64),
                                        (6, 20), (6, 64), (7, 4), (7, 64), (8, 4), (8, 32)])
def test_expert_gemv_bit_identical_to_per_expert_launches(bits, block):
    """Every width and a block of each kind gemv_route sends to "tc": 6
    experts holding 0, 1, 8, 3, 0 and 5 rows, N off the 16-column blocks,
    K of word counts on and off whole uint4s."""
    _need_cuda()
    rs = np.random.RandomState(bits * 10 + block)
    cpw = 32 // bits
    unit = cpw * block // np.gcd(cpw, block)
    for N, K in ((70, 8 * unit), (33, 3 * unit)):
        case = _experts_case(bits, block, N, K, [0, 1, 8, 3, 0, 5], rs)
        _experts_bit_identical(*case, bits, block)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(1408, 2048), (2048, 1408), (6400, 4096), (4096, 6400)])
def test_expert_gemv_at_moe_shapes(N, K):
    """moonshot-v1's and phi3.5-moe's expert matrices at 4 bits, block 64,
    8 experts (one empty, one of 8 rows, one of 1)."""
    _need_cuda()
    rs = np.random.RandomState(N + K)
    case = _experts_case(4, 64, N, K, [2, 0, 8, 1, 4, 0, 6, 3], rs)
    _experts_bit_identical(*case, 4, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 4])
def test_expert_gemv_row_independent_of_its_slot_and_neighbours(bits):
    """One activation row at each slot 0 to 7 of an expert's buffer, beside
    other random rows or none: its output is the same bits everywhere, and
    all experts empty launches and leaves nothing to compare."""
    _need_cuda()
    rs = np.random.RandomState(bits)
    x, packed, scales, cb, _ = _experts_case(bits, 64, 1408, 2048, [8, 8], rs)
    kw = dict(bits=bits, block_size=64)
    row = x[0, 0].clone()
    alone_x = x.clone()
    alone_x[0, 0] = row
    ref = tqm.qmatmul_gemv_experts(alone_x, packed, scales, cb,
                                   torch.tensor([1, 0], dtype=torch.int32, device="cuda"), **kw)
    for slot in range(tqm.GEMV_MAX_M):
        xs = torch.tensor(rs.randn(*x.shape), device="cuda").to(torch.bfloat16)
        xs[0, slot] = row
        y = tqm.qmatmul_gemv_experts(xs, packed, scales, cb,
                                     torch.tensor([8, 8], dtype=torch.int32, device="cuda"), **kw)
        torch.cuda.synchronize()
        assert torch.equal(y[0, slot].view(torch.int16), ref[0, 0].view(torch.int16)), slot
    empty = torch.zeros(2, dtype=torch.int32, device="cuda")
    tqm.qmatmul_gemv_experts(x, packed, scales, cb, empty, **kw)
    torch.cuda.synchronize()


def _moe_cfg(kv):
    """reduced() moonshot-v1 with experts of width 128 (rows of whole
    64-blocks, so every expert stack takes the kernels)."""
    return get_arch("moonshot-v1-16b-a3b").reduced(moe_d_ff=128).with_kv_quant(kv)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [16, 4])
def test_moe_engine_graph_tokens_equal_eager(kv):
    """The captured MoE decode step (routing, dispatch and combine on the
    device, no host sync): tokens equal eager steps', one expert-batched
    GEMV a matrix kind, layer and step, and prefill through a GEMM an
    expert that holds a token."""
    _need_cuda()
    from repro_torch.models import moe

    cfg = _moe_cfg(kv)
    params = _q4_params(cfg)
    assert all(moe.experts_fused_eligible(params["stack"][0]["ffn"][k].select(0))
               for k in moe.MOE_WEIGHTS)
    S, n = 20, 12
    prompts = torch.randint(0, cfg.vocab_size, (3, S), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(kv))
    e0 = tqm.qmatmul_gemv_experts.launches
    graph = Engine(params, cfg, max_seq_len=S + n, device="cuda").generate(prompts, n)
    torch.cuda.synchronize()
    # the capture's warm-up step and n - 1 replays
    assert tqm.qmatmul_gemv_experts.launches - e0 == 3 * cfg.n_layers * n
    assert torch.equal(graph, _eager(params, cfg, prompts, n, 0.0, None, S + n))


@pytest.mark.cuda
def test_moe_server_equals_engine_with_pad_masked_buckets():
    """reduced() moonshot-v1 at kv4 on 2 slots: prompts of 5 to 27 tokens
    bucket with the router pad mask; each request's tokens equal the
    per-request Engine's; chunked prefill is refused."""
    _need_cuda()
    cfg = _moe_cfg(4)
    params = _q4_params(cfg)
    rs = np.random.RandomState(4)
    reqs = [rs.randint(0, cfg.vocab_size, L) for L in (27, 9, 18, 5)]
    srv = Server(params, cfg, num_slots=2, max_seq_len=48, device="cuda")
    ids = [srv.submit(p, 14, arrival_time=float(i)) for i, p in enumerate(reqs)]
    res = srv.run_until_drained()
    for i, p in zip(ids, reqs):
        eng = Engine(params, cfg, max_seq_len=48, device="cuda").generate(
            torch.as_tensor(p, device="cuda")[None], 14)
        assert res[i] == eng[0].tolist(), i
    with pytest.raises(ValueError):
        Server(params, cfg, num_slots=2, max_seq_len=48, device="cuda", prefill_chunk=128)


def _ssm_cfg(name="mamba2-130m"):
    """reduced() SSM shapes with whole 64-blocks in every quantized row:
    d 128 (d_inner 256, 16 heads of 16), so the fused GEMV serves in_proj
    and out_proj."""
    return get_arch(name).reduced(d_model=128)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kv", [("mamba2-130m", 16), ("jamba-v0.1-52b", 4)])
def test_ssm_engine_graph_tokens_equal_eager(name, kv):
    """The captured SSM decode step (the state and conv updated in place,
    no host sync): tokens equal eager steps', two tensor-core GEMVs an SSM
    layer and step."""
    _need_cuda()
    cfg = _ssm_cfg(name).with_kv_quant(kv)
    params = _q4_params(cfg)
    S, n = 16, 12
    prompts = torch.randint(0, cfg.vocab_size, (3, S), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(kv))
    g0 = tqm.qmatmul_gemv_tc.launches
    graph = Engine(params, cfg, max_seq_len=S + n, device="cuda").generate(prompts, n)
    torch.cuda.synchronize()
    n_ssm = sum(m == "ssm" for m, _ in cfg.layer_schedule())
    assert tqm.qmatmul_gemv_tc.launches - g0 >= 2 * n_ssm * n
    assert torch.equal(graph, _eager(params, cfg, prompts, n, 0.0, None, S + n))


@pytest.mark.cuda
def test_ssm_decode_row_does_not_depend_on_the_batch():
    """A row's SSM decode step alone equals the same row among 8 bit for bit:
    its output, state and conv (the Server's pool against the Engine's
    batch of 1), through ssm_block_decode on full-width mamba2 shapes with
    4-bit in_proj and out_proj (B1's GEMV)."""
    _need_cuda()
    from repro_torch.models import ssm
    from repro_torch.models.layers import Init
    from repro_torch.models.quantize import quantize_unit

    cfg = get_arch("mamba2-130m")
    p = ssm.init_ssm(Init(0, torch.device("cuda"), torch.bfloat16), cfg)
    for key in ("in_proj", "out_proj"):
        p[key]["w"] = quantize_unit("matrix", p[key]["w"], QuantConfig(bits=4))
    g = torch.Generator("cuda").manual_seed(3)
    u = torch.randn((8, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    cache = ssm.init_ssm_cache(cfg, 8, device="cuda")
    cache["state"].normal_(generator=g)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=g, device="cuda"))
    one = {k: v[3:4].clone() for k, v in cache.items()}
    with torch.inference_mode():
        y8 = ssm.ssm_block_decode(p, u, cache, cfg)
        y1 = ssm.ssm_block_decode(p, u[3:4], one, cfg)
    assert torch.equal(y8[3:4].view(torch.int16), y1.view(torch.int16))
    assert torch.equal(cache["state"][3:4], one["state"])
    assert torch.equal(cache["conv"][3:4].view(torch.int16), one["conv"].view(torch.int16))


def _s2s_case(seed):
    """reduced() seamless (2 + 2 layers, d 64, 4 heads over 2 KV heads, an
    untied 256-row head) with 4-bit weights, frames and tokens on the card."""
    from repro_torch.models import seq2seq

    cfg = get_arch("seamless-m4t-large-v2").reduced()
    params = quantize_params(seq2seq.init_params(cfg, seed=0, device="cuda",
                                                 dtype=torch.bfloat16),
                             QuantConfig(bits=4), cfg, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    frames = torch.randn((3, 40, cfg.d_model), generator=g, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (3, 12), generator=g, device="cuda")
    return cfg, params, frames, toks


def _s2s_logits(params, cfg, frames, toks, prefix):
    """The prefill over toks[:, :prefix], then decode steps fed the rest:
    every step's logits [B, T - prefix + 1, V] in f32."""
    from repro_torch.models import seq2seq

    with torch.inference_mode():
        logits, caches = seq2seq.prefill(params, frames, toks[:, :prefix], cfg)
        out = [logits.float()]
        pos = torch.full((), prefix, dtype=torch.int32, device="cuda")
        for t in range(prefix, toks.shape[1]):
            logits, caches = seq2seq.decode_step(params, toks[:, t], caches, pos, cfg)
            out.append(logits.float())
            pos.add_(1)
    return torch.stack(out, 1)


@pytest.mark.cuda
def test_seq2seq_fused_within_dequant_einsum():
    """The encoder-decoder's prefill and decode steps through B1's kernels
    (one tensor-core GEMV a product and step, the encoder's and cross K/V's
    products GEMMs) within 0.5 of dequant_einsum's logits, which launch no
    B1 kernel."""
    _need_cuda()
    cfg, params, frames, toks = _s2s_case(5)
    g0, m0 = tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemm.launches
    # a prefix of 2 on 3 rows: the decoder's prefill products are GEMVs (6 rows)
    fused = _s2s_logits(params, cfg.with_matmul_mode("fused"), frames, toks, 2)
    torch.cuda.synchronize()
    n_dec, n_enc = cfg.n_layers, cfg.n_encoder_layers
    assert tqm.qmatmul_gemv_tc.launches - g0 == (9 * n_dec + 1) * (1 + toks.shape[1] - 2)
    assert tqm.qmatmul_gemm.launches - m0 == 1 + 7 * n_enc + 2 * n_dec
    g0, m0 = tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemm.launches
    plain = _s2s_logits(params, cfg.with_matmul_mode("dequant_einsum"), frames, toks, 2)
    assert (tqm.qmatmul_gemv_tc.launches, tqm.qmatmul_gemm.launches) == (g0, m0)
    assert bool(torch.isfinite(fused).all())
    assert float((fused - plain).abs().max()) <= 0.5


@pytest.mark.cuda
def test_seq2seq_captured_step_equals_eager():
    """One seq2seq.decode_step captured as a CUDA graph (capture_graph) from
    the prefill's caches: its logits equal an eager step's from the same
    caches bit for bit, and it wrote the token's K/V in place."""
    _need_cuda()
    from repro_torch.models import seq2seq
    from repro_torch.serving.engine import capture_graph

    cfg, params, frames, toks = _s2s_case(6)
    with torch.inference_mode():
        _, caches = seq2seq.prefill(params, frames, toks[:, :4], cfg)
        snap = {k: v.clone() for k, v in caches[0].items()}
        tok, pos = toks[:, 4].contiguous(), torch.full((), 4, dtype=torch.int32, device="cuda")
        box = {}

        def body():
            logits, _ = seq2seq.decode_step(params, tok, caches, pos, cfg)
            if "out" not in box:
                box["out"] = torch.empty_like(logits)
            box["out"].copy_(logits)

        graph = capture_graph(body, torch.device("cuda"))
        for k, v in snap.items():
            caches[0][k].copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        replayed = box["out"].clone()
        written = caches[0]["pos"].clone()
        for k, v in snap.items():
            caches[0][k].copy_(v)
        eager, _ = seq2seq.decode_step(params, tok, caches, pos, cfg)
    assert torch.equal(replayed.view(torch.int16), eager.view(torch.int16))
    assert bool((written[:, :5] == torch.arange(5, device="cuda")).all())
    assert bool((written[:, 5:] == -1).all())


def _profiled_programs(device, kv):
    """tiny-160k's prefill[2x7] and decode_step[2] costed on ``device`` by
    a profiled Engine (4-bit weights from one CPU tree), and its tokens."""
    from repro_torch.serving import StepProfiler

    cfg = get_arch("tiny-160k").with_kv_quant(kv)
    params = _tree_to(quantize_params(lm.init_params(cfg, seed=0, device="cpu"),
                                      QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                                      device="cpu"), device)
    prompts = torch.tensor(np.random.RandomState(80).randint(0, 2048, (2, 7)), device=device)
    tel = Telemetry(profiler=StepProfiler())
    eng = Engine(params, cfg, max_seq_len=14, telemetry=tel, device=device)
    out = eng.generate(prompts, 5)
    (session,) = tel.profiler.sessions
    return session.costs, out, params, cfg, prompts, eng


def _tree_to(tree, device):
    from repro_torch.core.qtensor import QuantizedTensor

    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    if isinstance(tree, QuantizedTensor):
        import dataclasses

        return dataclasses.replace(tree, **{f.name: getattr(tree, f.name).to(device)
                                            for f in dataclasses.fields(tree)
                                            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [16, 4])
def test_profiled_costs_equal_on_card_and_cpu(kv):
    _need_cuda()
    cpu, _, _, _, _, _ = _profiled_programs("cpu", kv)
    card, out_card, params, cfg, prompts, profiled = _profiled_programs("cuda", kv)
    for name, a in cpu.items():
        b = card[name]
        assert (a.flops, a.dot_flops, a.kernel_flops, a.kernel_bytes) == \
            (b.flops, b.dot_flops, b.kernel_flops, b.kernel_bytes), name
        assert abs(b.hbm_bytes - a.hbm_bytes) <= 0.01 * a.hbm_bytes, name
    assert card["decode_step[2]"].dot_flops == 964_608
    # the profiled Engine's tokens and one replay's launches are the unprofiled ones
    eng = Engine(params, cfg, max_seq_len=14, device="cuda")
    assert torch.equal(eng.generate(prompts, 5), out_card)
    assert profiled._graphs[2].step.launched == eng._graphs[2].step.launched
    assert sum(eng._graphs[2].step.launched) > 0


@pytest.mark.cuda
def test_profiled_paged_server_tokens_equal_unprofiled():
    _need_cuda()
    from repro_torch.serving import NOOP, StepProfiler

    cfg = get_arch("tiny-160k").with_kv_quant(4)
    params = quantize_params(lm.init_params(cfg, seed=0, device="cuda"),
                             QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                             device="cuda")
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 2048, n) for n in (10, 6, 20, 8)]

    def serve(tel):
        srv = Server(params, cfg, num_slots=2, max_seq_len=32, paged=True, page_size=8,
                     telemetry=tel, device="cuda")
        ids = [srv.submit(p, 5, arrival_time=float(i)) for i, p in enumerate(prompts)]
        res = srv.run_until_drained()
        return [res[i] for i in ids], srv

    tel = Telemetry(profiler=StepProfiler())
    on, srv = serve(tel)
    off, _ = serve(NOOP)
    assert on == off
    rows = tel.profiler.summary()
    assert {r["program"] for r in rows} >= {"decode_step"}
    assert all(0 < r["roofline_frac"] <= 1 for r in rows)


@pytest.mark.cuda
def test_grad_compression_on_card_equals_cpu():
    _need_cuda()
    from repro_torch.optim import grad_compress as gc
    from repro_torch.tree import leaves

    rs = np.random.RandomState(0)
    tree = {"w": torch.tensor(rs.randn(96, 64) * 0.01, dtype=torch.float32),
            "b": torch.tensor(rs.randn(64) * 0.01, dtype=torch.float32),
            "v": torch.tensor(rs.randn(5000) * 0.01, dtype=torch.float32)}
    card = {k: v.cuda() for k, v in tree.items()}
    n0 = launches.snapshot()
    g1, e1 = gc.compress_tree(card, None)
    g2, e2 = gc.compress_tree(card, e1)
    torch.cuda.synchronize()
    delta = [a - b for a, b in zip(launches.snapshot(), n0)]
    from repro_torch.kernels import quantize as tq

    assert tq.quantize_blocks_cuda.launches - n0[7] == 4 and sum(delta) == 4
    p1, q1 = gc.compress_tree(tree, None)
    p2, q2 = gc.compress_tree(tree, q1)
    for c, p in ((g1, p1), (e1, q1), (g2, p2), (e2, q2)):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(leaves(c), leaves(p)))


@pytest.mark.cuda
def test_audit_grid_on_tiny_160k(tmp_path):
    """The auditor's tiny-160k grid at kv16, kv8 and kv4 passes on the card,
    with every graph check run."""
    _need_cuda()
    from repro_torch.analysis import audit

    report = audit.run_audit(kv_bits=(16, 8, 4), dot_dir=tmp_path)
    assert report.ok, "\n".join(c.render() for c in report.failures())
    checks = {(c.program, c.check) for c in report.checks}
    for tag in ("kv16", "kv8", "kv4"):
        assert (f"server.paged[{tag}]", "recapture") in checks
        assert (f"server.decode_step[{tag}+fused]", "kernel_nodes") in checks
        assert (f"engine.decode_step[{tag},B2]", "no_host_nodes") in checks
        assert (f"server.paged[{tag}]", "in_place[wipe_pages]") in checks
    assert len(report.families) == 3 * 6


@pytest.mark.cuda
def test_audit_catches_a_host_copy_in_a_captured_body(tmp_path):
    """A body that copies a host value into the step: pageable, PyTorch
    refuses it at capture; pinned, it is captured as a host-to-device
    memcpy node read at every replay, and no_host_nodes fails."""
    _need_cuda()
    from repro_torch.analysis import audit
    from repro_torch.serving.engine import capture_graph

    buf = torch.zeros(2, device="cuda")
    with pytest.raises(RuntimeError, match="pinned"):
        capture_graph(lambda: buf.copy_(torch.tensor([1.0, 2.0], device="cuda")), "cuda")
    torch.cuda.synchronize()
    host = torch.tensor([1.0, 2.0]).pin_memory()
    step = capture_graph(lambda: buf.copy_(host.to("cuda", non_blocking=True) * 2), "cuda",
                         debug=True)
    step.replay()
    torch.cuda.synchronize()
    assert buf.tolist() == [2.0, 4.0]
    report = audit.AuditReport()
    nodes = audit.audit_graph(report, "broken", step, tmp_path / "host.dot")
    assert [c.check for c in report.failures()] == ["no_host_nodes"]
    assert [n.kind for n in nodes if n.touches_host] == ["HtoD"]


@pytest.mark.cuda
def test_audit_catches_a_buffer_rebound_after_capture(tmp_path):
    """A Server that rebinds its token buffer after its step was captured
    (the graph goes on reading the old one): in_place fails, and only it."""
    _need_cuda()
    from repro_torch.analysis import audit

    class Rebinding(Server):
        def _decode_once(self):
            self._tok = torch.zeros_like(self._tok)
            return super()._decode_once()

    cfg = get_arch("tiny-160k").with_kv_quant(4)
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    report = audit.AuditReport()
    audit.audit_server_slot(report, params, cfg, "kv4", device="cuda", dot_dir=tmp_path,
                            server=Rebinding)
    assert [(c.check, c.detail.split(":")[0]) for c in report.failures()] == \
        [("in_place", "rebound")]


@pytest.mark.cuda
def test_bench_diff_of_a_card_candidate_against_the_reference_ledger(tmp_path):
    """The pinned serve record (ledger.SERVE_ARGS, PAGED_ARGS) served on the
    card, diffed with the port's bench_diff CLI against the reference's
    committed BENCH_SERVE.json: exit 0, every virtual series within its tol
    (steps, latency, byte ratios exact)."""
    _need_cuda()
    from repro_torch.paper import bench_diff, ledger

    rec = ledger.serve_record(lambda *a: None, device="cuda")
    assert rec["meta"]["platform"] == "cuda" and rec["meta"]["torch_version"]
    cand = ledger.write(tmp_path / "BENCH_SERVE.candidate.json", "serve", [rec])
    report = tmp_path / "report.txt"
    assert bench_diff.main(["--baseline", str(ledger.REFERENCE_SERVE_LEDGER),
                            "--new", str(cand), "--report", str(report)]) == 0
    assert "ok        serve.kv4_steps: 89 -> 89" in report.read_text()


@pytest.mark.cuda
def test_serve_bench_static_equals_continuous_at_full_width():
    """serve_bench.run on Qwen2-7B at full width and depth (seeded random
    weights, 4-bit float b64, prompts from the first 4096 ids): the static
    Engine's greedy tokens equal the continuous Server's, request for
    request, at kv16 (the reference's gate) and at kv4 (kv_gate="tokens"),
    and kv4 cuts the KV bytes at least 3x."""
    _need_cuda()
    from repro_torch.paper import serve_bench

    cfg = get_arch("qwen2-7b")
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg)
    del params
    _, stats = serve_bench.run(lambda *a: None, arch="qwen2-7b", params=qparams, device="cuda",
                               num_slots=8, n_requests=8, kv_bits=4, kv_gate="tokens")
    # kv_bits=4: the kv16 pool gives the byte baseline only; the kv4 sweep
    # runs the static Engine and the Server over the same packed cache
    assert stats["kv4_static_equals_continuous"] and stats["kv4_ratio"] >= 3.0
    _, stats = serve_bench.run(lambda *a: None, arch="qwen2-7b", params=qparams, device="cuda",
                               num_slots=8, n_requests=8, kv_bits=16)
    assert stats["kv16_static_equals_continuous"] and stats["tok_s_static"] > 0


# -- serving on a 1x1 mesh: NCCL at world size 1 -------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one rank on the card (NCCL, a file:// rendezvous) and its
    1x1 ("data", "model") mesh; the process group is destroyed after the
    module's cases."""
    _need_cuda()
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_mesh

    init_world("cuda", rank=0, world=1,
               init_file=str(tmp_path_factory.mktemp("nccl") / "rendezvous"))
    try:
        yield make_mesh(1, 1, "cuda")
    finally:
        dist.destroy_process_group()


def _routed_read(q, k_new, v_new, cache, pos, *, cap=0.0, window=0, kvq=None):
    """The unsharded read the 1x1 mesh equals: write_cache_decode, then the
    routed read of a packed cache (the partials for a bf16 one)."""
    from repro_torch.models import attention

    attention.write_cache_decode(cache, k_new, v_new, pos, window=window, kvq=kvq)
    if kvq is not None and "k_packed" in cache:
        return tka.decode_attention_packed_routed(q, cache, pos, kvq, cap=cap, window=window)
    B, H, Dh = q.shape
    m, l, pv = attention.decode_attention_partial(q, cache["k"], cache["v"], cache["pos"], pos,
                                                  cap=cap, window=window)
    return attention.combine_partials(m, l, pv).reshape(B, H, Dh).to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [16, 8, 4])
def test_mesh_1x1_engine_equals_unsharded_routed_read(nccl_mesh, kv):
    """tiny-650k, 4-bit weights: the sharded Engine's captured steps give
    the tokens of eager unsharded steps reading every layer the routed way,
    whose logits the sharded eager steps equal bit for bit; each step one
    KV dequant a layer at kv8 and kv4 and no fused attention."""
    from repro_torch.models.sharding import Sharder

    cfg = get_arch("tiny-650k").with_kv_quant(kv)
    qparams = quantize_params(lm.init_params(cfg, seed=0, device="cuda"),
                              QuantConfig(bits=4, dtype="float", block_size=64), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (4, 24), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(kv))
    n, S = 8, 32
    engine = Engine(qparams, cfg, max_seq_len=S, device="cuda",
                    sharder=Sharder(nccl_mesh, cfg, replicate_params_below=0))
    before = launches.snapshot()
    tokens = engine.generate(prompts, n)
    counts = dict(zip(launches.names(), (a - b for a, b in zip(launches.snapshot(), before))))
    want_kv = n * cfg.n_layers if kv < 16 else 0
    assert counts["dequant_kv_cuda.launches"] == want_kv
    assert counts["decode_attention_packed_cuda.launches"] == 0
    with torch.inference_mode():
        logits, caches = engine._prefill(prompts)
        want, wcaches = lm.prefill(qparams, prompts, cfg, cache_len=S)
        assert torch.equal(logits, want)
        read = engine._decode_attn(4)
        for t in range(n - 1):
            logits, caches = lm.decode_step(engine.params, tokens[:, t], caches, 24 + t,
                                            cfg, decode_attn=read)
            want, wcaches = lm.decode_step(qparams, tokens[:, t], wcaches, 24 + t, cfg,
                                           decode_attn=_routed_read)
            assert torch.equal(logits, want), t
            assert torch.equal(torch.argmax(want, -1).to(torch.int32), tokens[:, t + 1])


@pytest.mark.cuda
def test_mesh_1x1_server_equals_sharded_engine(nccl_mesh):
    """The sharded Server (kv4, 2 slots, one graph for the pool step) gives
    each request the sharded batch-1 Engine's tokens."""
    from repro_torch.models.sharding import Sharder

    cfg = get_arch("tiny-650k").with_kv_quant(4)
    qparams = quantize_params(lm.init_params(cfg, seed=1, device="cuda"),
                              QuantConfig(bits=4, dtype="float", block_size=64), cfg)
    sharder = Sharder(nccl_mesh, cfg, replicate_params_below=0)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, cfg.vocab_size, L) for L in (9, 20, 5, 14)]
    srv = Server(qparams, cfg, num_slots=2, max_seq_len=40, sharder=sharder, device="cuda")
    ids = [srv.submit(p, 8, arrival_time=0.5 * i) for i, p in enumerate(prompts)]
    res = srv.run_until_drained()
    eng = Engine(qparams, cfg, max_seq_len=40, sharder=sharder, device="cuda")
    for p, i in zip(prompts, ids):
        assert res[i] == eng.generate(torch.as_tensor(p, device="cuda")[None], 8)[0].tolist()


# -- training on a 1x1 mesh: NCCL at world size 1 ------------------------------

def _train_runs(sharders, *, donate, cfg=None):
    """Two train steps of ``cfg`` (tiny-650k by default) on the card per
    sharder (None = unsharded) from one seeded bf16 init, 8-bit
    compression, 2 microbatches: [(per-step loss and norm, the state's
    leaves, the flat encodes launched)]."""
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves

    cfg = cfg or get_arch("tiny-650k")
    g = torch.Generator("cuda").manual_seed(0)
    batches = [torch.randint(0, cfg.vocab_size, (4, 65), device="cuda", generator=g)
               for _ in range(2)]
    runs = []
    for sharder in sharders:
        state = tstep.init_state(cfg, device="cuda", grad_compress_bits=8,
                                 param_dtype=torch.bfloat16)
        step = tstep.make_train_step(cfg, sharder=sharder, grad_compress_bits=8,
                                     microbatches=2, loss_chunk=64, donate=donate)
        before = launches.snapshot()
        metrics = []
        for t in batches:
            state, m = step(state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        counts = dict(zip(launches.names(), (a - b for a, b in zip(launches.snapshot(),
                                                                      before))))
        runs.append((metrics, leaves(state), counts["quantize_blocks_cuda.launches"]))
    return runs


@pytest.mark.cuda
def test_train_mesh_1x1_steps_equal_unsharded_bit_for_bit(nccl_mesh):
    """The sharded train step (FSDP storage, bf16 masters, remat, 8-bit
    compression, 2 microbatches, the state donated) on the 1x1 mesh gives
    the unsharded step's loss, norm and state bit for bit, and launches one
    flat encode a compressed leaf and step."""
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim import grad_compress

    cfg = get_arch("tiny-650k")
    sharder = Sharder(nccl_mesh, cfg, replicate_params_below=0)
    (m1, s1, n1), (m2, s2, n2) = _train_runs([sharder, None], donate=True)
    assert m1 == m2
    assert all(torch.equal(a, b) for a, b in zip(s1, s2, strict=True))
    big = sum(int(np.prod(n)) >= grad_compress.MIN_ELEMENTS
              for n in sharder.train_placement().shapes)
    assert n1 == n2 == 2 * big


@pytest.mark.cuda
def test_train_mesh_1x1_checkpoint_and_remesh_round_trip(nccl_mesh, tmp_path):
    """A sharded train state saved through the CheckpointManager (gathered
    whole, rank 0 writing) reads back unsharded and through
    launch/elastic.remesh_state equal to it bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import elastic
    from repro_torch.models.sharding import Sharder
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves

    cfg = get_arch("tiny-650k")
    sharder = Sharder(nccl_mesh, cfg, replicate_params_below=0)
    state = tstep.init_state(cfg, device="cuda", grad_compress_bits=8,
                             param_dtype=torch.bfloat16)
    t = torch.randint(0, cfg.vocab_size, (4, 33), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    state, _ = tstep.make_train_step(cfg, sharder=sharder, grad_compress_bits=8,
                                     loss_chunk=32)(state, {"tokens": t[:, :-1],
                                                            "labels": t[:, 1:]})
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state, sharder=sharder, block=True)
    _, whole, _ = mgr.restore(state)
    remeshed, _ = elastic.remesh_state(whole, cfg, nccl_mesh, sharder=sharder)
    _, restored, _ = mgr.restore(state, sharder=sharder)
    for tree in (whole, remeshed, restored):
        assert all(torch.equal(a, b) for a, b in zip(leaves(tree), leaves(state), strict=True))


# -- MoE, SSM and hybrid decoders on a 1x1 mesh: NCCL at world size 1 ----------

#: reduced() configs of the MoE, SSM and hybrid archs, kv4 where they attend;
#: their experts are 32 wide, so their weights are quantized in blocks of 32
MOE_SSM_MESH_ARCHS = ("moonshot-v1-16b-a3b", "mamba2-130m", "jamba-v0.1-52b")


def _moe_ssm_mesh_model(name, seed=0):
    cfg = get_arch(name).reduced()
    if any(m.startswith("attn") for m, _ in cfg.layer_schedule()):
        cfg = cfg.with_kv_quant(4)
    qparams = quantize_params(lm.init_params(cfg, seed=seed, device="cuda"),
                              QuantConfig(bits=4, dtype="float", block_size=32), cfg)
    return cfg, qparams


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_SSM_MESH_ARCHS)
def test_moe_ssm_mesh_1x1_engine_equals_unsharded_routed_read(nccl_mesh, name):
    """A reduced() MoE, SSM or hybrid decoder, 4-bit weights: the sharded
    Engine's captured steps give the tokens of eager unsharded steps
    reading every attention layer the routed way, whose logits and prefill
    caches (K/V, SSM state and conv) the sharded eager steps equal bit for
    bit; each MoE layer one expert-batched GEMV a matrix kind and step."""
    from repro_torch.models.sharding import Sharder

    cfg, qparams = _moe_ssm_mesh_model(name)
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    n, S = 8, 32
    engine = Engine(qparams, cfg, max_seq_len=S, device="cuda",
                    sharder=Sharder(nccl_mesh, cfg, replicate_params_below=0))
    before = launches.snapshot()
    tokens = engine.generate(prompts, n)
    counts = dict(zip(launches.names(), (a - b for a, b in zip(launches.snapshot(), before))))
    n_moe = sum(f == "moe" for _, f in cfg.layer_schedule())
    # n - 1 replays and the capture's warm-up step
    assert counts["qmatmul_gemv_experts.launches"] == 3 * n_moe * n
    assert counts["decode_attention_packed_cuda.launches"] == 0
    with torch.inference_mode():
        logits, caches = engine._prefill(prompts)
        want, wcaches = lm.prefill(qparams, prompts, cfg, cache_len=S)
        assert torch.equal(logits, want)
        for a, b in zip(caches, wcaches, strict=True):
            assert all(torch.equal(a[k], b[k]) for k in a)
        read = engine._decode_attn(4)
        for t in range(n - 1):
            logits, caches = lm.decode_step(engine.params, tokens[:, t], caches, 16 + t, cfg,
                                            decode_attn=read, constrain=engine.constrain)
            want, wcaches = lm.decode_step(qparams, tokens[:, t], wcaches, 16 + t, cfg,
                                           decode_attn=_routed_read)
            assert torch.equal(logits, want), t
            assert torch.equal(torch.argmax(want, -1).to(torch.int32), tokens[:, t + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_SSM_MESH_ARCHS)
def test_moe_ssm_mesh_1x1_server_equals_sharded_engine(nccl_mesh, name):
    """The sharded Server (2 slots, one graph for the pool step; MoE
    prefills bucketed with the router's pad mask, SSM ones at their exact
    length) gives each request the sharded batch-1 Engine's tokens."""
    from repro_torch.models.sharding import Sharder

    cfg, qparams = _moe_ssm_mesh_model(name, seed=1)
    sharder = Sharder(nccl_mesh, cfg, replicate_params_below=0)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, cfg.vocab_size, L) for L in (8, 16, 5, 8)]
    srv = Server(qparams, cfg, num_slots=2, max_seq_len=40, sharder=sharder, device="cuda")
    ids = [srv.submit(p, 8, arrival_time=0.5 * i) for i, p in enumerate(prompts)]
    res = srv.run_until_drained()
    eng = Engine(qparams, cfg, max_seq_len=40, sharder=sharder, device="cuda")
    for p, i in zip(prompts, ids):
        assert res[i] == eng.generate(torch.as_tensor(p, device="cuda")[None], 8)[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_SSM_MESH_ARCHS[:2])
def test_moe_ssm_mesh_1x1_train_steps_equal_unsharded(nccl_mesh, name):
    """moonshot's and mamba2's reduced() configs: the sharded train steps
    (bf16 masters, remat, 8-bit compression, 2 microbatches, the state
    donated) on the 1x1 mesh give the unsharded steps' loss, norm and state
    bit for bit, one flat encode a compressed leaf and step."""
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim import grad_compress

    cfg = get_arch(name).reduced()
    sharder = Sharder(nccl_mesh, cfg, replicate_params_below=0)
    (m1, s1, n1), (m2, s2, n2) = _train_runs([sharder, None], donate=True, cfg=cfg)
    assert m1 == m2
    assert all(torch.equal(a, b) for a, b in zip(s1, s2, strict=True))
    big = sum(int(np.prod(n)) >= grad_compress.MIN_ELEMENTS
              for n in sharder.train_placement().shapes)
    assert n1 == n2 == 2 * big


@pytest.mark.cuda
def test_moe_ssm_mesh_expert_gemv_on_a_slice_equals_whole_stack():
    """The expert-batched GEMV on a rank's slice of a stack (experts 4-7 of
    16, their own storage, their buffers a view of the whole one's, the
    local counts) gives those experts' rows of the whole-stack launch bit
    for bit."""
    _need_cuda()
    from repro_torch.core.codebooks import make_codebook

    g = torch.Generator("cuda").manual_seed(5)
    E, e0, El, N, K = 16, 4, 4, 256, 512
    kw = dict(bits=4, block_size=64)
    counts = torch.randint(0, tqm.GEMV_MAX_M + 1, (E,), generator=g, device="cuda",
                           dtype=torch.int32)
    packed = torch.randint(-2**31, 2**31 - 1, (E, N, K // 8), generator=g, device="cuda",
                           dtype=torch.int32)
    scales = (torch.rand((E, N, K // 64), generator=g, device="cuda") * 0.04 + 0.01).to(
        torch.bfloat16)
    cb = make_codebook("float", 4, device="cuda").expand(E, -1).contiguous()
    buf = torch.randn((E, tqm.GEMV_MAX_M + 1, K), generator=g, device="cuda").to(torch.bfloat16)
    whole = tqm.qmatmul_gemv_experts(buf[:, :tqm.GEMV_MAX_M], packed, scales, cb, counts, **kw)
    part = tqm.qmatmul_gemv_experts(buf[e0:e0 + El, :tqm.GEMV_MAX_M],
                                    *(t[e0:e0 + El].clone() for t in (packed, scales, cb)),
                                    counts[e0:e0 + El].clone(), **kw)
    for e in range(El):
        c = int(counts[e0 + e])
        assert torch.equal(part[e, :c].view(torch.int16), whole[e0 + e, :c].view(torch.int16))


# -- the encoder-decoder, preemption and the profiler on a 1x1 mesh ---------------

def _s2s_rollout(params, cfg, frames, bos, n, sharder=None):
    """(tokens, logits, caches) of seq2seq.prefill and n - 1 greedy decode
    steps; sharded: the sharder's placement and reads."""
    from repro_torch.models import seq2seq

    B = frames.shape[0]
    kw, step_kw = {}, {}
    if sharder is not None:
        params = sharder.shard_params(params)
        kw = dict(constrain=sharder.constrain, q_pad=sharder.head_pad())
        step_kw = dict(constrain=sharder.constrain,
                       decode_attn=sharder.decode_attn_fn(B, cfg.decoder_cache_len),
                       cross_attn=sharder.cross_attn_fn(B, frames.shape[1]))
    with torch.inference_mode():
        logits, caches = seq2seq.prefill(params, frames, bos, cfg, **kw)
        if sharder is not None:
            caches = sharder.shard_caches(caches, B)
        toks, logs = [logits.argmax(-1).to(torch.int32)], [logits]
        for t in range(n - 1):
            logits, caches = seq2seq.decode_step(params, toks[-1], caches, bos.shape[1] + t,
                                                 cfg, **step_kw)
            toks.append(logits.argmax(-1).to(torch.int32))
            logs.append(logits)
    return torch.stack(toks, 1), torch.stack(logs, 1), caches


@pytest.mark.cuda
def test_encdec_mesh_1x1_prefill_and_decode_equal_unsharded(nccl_mesh):
    """seamless's reduced() config, 4-bit weights: the sharded prefill and
    decode steps (the sharder's constrain, q_pad, decode and cross reads,
    caches placed by shard_caches) equal the unsharded ones bit for bit:
    logits, tokens, the self and cross caches."""
    from repro_torch.models import seq2seq
    from repro_torch.models.sharding import Sharder

    cfg = get_arch("seamless-m4t-large-v2").reduced()
    qparams = quantize_params(seq2seq.init_params(cfg, seed=0, device="cuda"),
                              QuantConfig(bits=4, dtype="float", block_size=64), cfg)
    g = torch.Generator("cuda").manual_seed(2)
    frames = torch.randn((4, 16, cfg.d_model), generator=g, device="cuda")
    bos = torch.zeros((4, 2), dtype=torch.int64, device="cuda")
    sharder = Sharder(nccl_mesh, cfg, replicate_params_below=0)
    t0, l0, c0 = _s2s_rollout(qparams, cfg, frames, bos, 8)
    t1, l1, c1 = _s2s_rollout(qparams, cfg, frames, bos, 8, sharder)
    assert torch.equal(t0, t1) and torch.equal(l0.view(torch.int16), l1.view(torch.int16))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(c0, c1) for k in a)


@pytest.mark.cuda
def test_encdec_mesh_1x1_train_steps_equal_unsharded(nccl_mesh):
    """seamless's reduced() config trained two steps on the 1x1 mesh (FSDP
    storage, bf16 masters, remat, 8-bit compression, 2 microbatches) gives
    the unsharded steps' loss, norm and state bit for bit."""
    from repro_torch.models.sharding import Sharder
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves

    cfg = get_arch("seamless-m4t-large-v2").reduced()
    g = torch.Generator("cuda").manual_seed(0)
    batches = []
    for _ in range(2):
        t = torch.randint(0, cfg.vocab_size, (4, 17), device="cuda", generator=g)
        batches.append({"frames": torch.randn((4, 32, cfg.d_model), generator=g,
                                              device="cuda").to(torch.bfloat16),
                        "tokens": t[:, :-1], "labels": t[:, 1:]})
    runs = []
    for sharder in (Sharder(nccl_mesh, cfg, replicate_params_below=0), None):
        state = tstep.init_state(cfg, device="cuda", grad_compress_bits=8,
                                 param_dtype=torch.bfloat16)
        step = tstep.make_train_step(cfg, sharder=sharder, grad_compress_bits=8,
                                     microbatches=2, donate=True)
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs.append((metrics, leaves(state)))
    (m1, s1), (m2, s2) = runs
    assert m1 == m2
    assert all(torch.equal(a, b) for a, b in zip(s1, s2, strict=True))


@pytest.mark.cuda
def test_mesh_1x1_preempted_server_equals_unsharded_and_engine(nccl_mesh):
    """tiny-650k at kv4, 2 slots, max_preemptions 1: an urgent request
    evicts a background one, which resumes in the other slot; the sharded
    Server's tokens equal the unsharded preempted Server's (its step over
    the routed read) and the sharded batch-1 Engine's, and both spill the
    same bytes."""
    from repro_torch.models.sharding import Sharder

    cfg = get_arch("tiny-650k").with_kv_quant(4)
    qparams = quantize_params(lm.init_params(cfg, seed=1, device="cuda"),
                              QuantConfig(bits=4, dtype="float", block_size=64), cfg)
    sharder = Sharder(nccl_mesh, cfg, replicate_params_below=0)
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, cfg.vocab_size, 6), 4, 0.0, 1),
            (rs.randint(0, cfg.vocab_size, 9), 12, 0.0, 1),
            (rs.randint(0, cfg.vocab_size, 5), 8, 2.0, 0)]

    class Routed(Server):
        def _decode_program(self, caches):
            logits, _ = lm.decode_step(self.params, self._tok, caches, self.pool._pos_dev,
                                       self.cfg, decode_attn=_routed_read)
            return sample_token(logits, self._gen, self._temps_dev)

    out = []
    for cls, sh in ((Server, sharder), (Routed, None)):
        tel = Telemetry()
        srv = cls(qparams, cfg, num_slots=2, max_seq_len=32, sharder=sh, max_preemptions=1,
                  telemetry=tel, device="cuda")
        ids = [srv.submit(p, n, arrival_time=a, priority=c) for p, n, a, c in reqs]
        res = srv.run_until_drained()
        out.append(([res[i] for i in ids], srv.scheduler.n_preemptions,
                    tel.registry.counter("kv_spill_bytes_total", kind="packed").value))
    (t1, n1, b1), (t2, n2, b2) = out
    assert n1 == n2 == 1 and b1 == b2 > 0
    assert t1 == t2
    eng = Engine(qparams, cfg, max_seq_len=32, sharder=sharder, device="cuda")
    for (p, n, _, _), t in zip(reqs, t1):
        assert eng.generate(torch.as_tensor(p, device="cuda")[None], n)[0].tolist() == t


@pytest.mark.cuda
def test_mesh_1x1_profiler_dot_flops_equal_unsharded(nccl_mesh):
    """The profiled sharded Engine (tiny-650k, kv4): tokens as unprofiled,
    each program's dot FLOPs the unsharded program's, collective bytes
    counted, every roofline_frac in (0, 1]."""
    from repro_torch.models.sharding import Sharder
    from repro_torch.serving import StepProfiler

    cfg = get_arch("tiny-650k").with_kv_quant(4)
    qparams = quantize_params(lm.init_params(cfg, seed=2, device="cuda"),
                              QuantConfig(bits=4, dtype="float", block_size=64), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (4, 24), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(6))
    costs, tokens = [], []
    for sh in (Sharder(nccl_mesh, cfg, replicate_params_below=0), None):
        tel = Telemetry(profiler=StepProfiler())
        engine = Engine(qparams, cfg, max_seq_len=32, sharder=sh, telemetry=tel,
                        device="cuda")
        tokens.append(engine.generate(prompts, 8))
        costs.append(tel.profiler.sessions[0].costs)
        assert all(0.0 < r["roofline_frac"] <= 1.0 for r in tel.profiler.summary())
    assert sorted(costs[0]) == sorted(costs[1]) == ["decode_step[4]", "prefill[4x24]"]
    for name, pc in costs[0].items():
        assert pc.dot_flops == costs[1][name].dot_flops
        assert pc.collective_bytes > 0 and costs[1][name].collective_bytes == 0
