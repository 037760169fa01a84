"""The port's training and paper-sweep slice against the JAX package.

Inputs come from numpy seeds (or from the reference, carried across as
numpy) and go through both packages.  The bars:
  * ``make_transition_logits``: the same bytes; ``entropy_floor`` within
    1e-5 relative (both sum in f32 in different orders: the reference's
    value is itself 2.2e-5 nats, 5.9e-6 relative, off the f64 sum and the
    port's 5e-6 relative off the reference's); the port's sampler (its own ``torch.Generator`` stream, which
    cannot be the reference's) draws bigrams whose per-state frequencies
    are within 0.05 total variation of ``softmax(logits)``;
  * ``cosine_lr``, AdamW: within 1e-6 relative (the same f32 formulas;
    the reference's XLA fuses them, which can move the last ulp);
  * ``bits_report``: dicts equal; ``scaling_laws``: identical results;
  * 8 train steps of tiny-160k from the reference's initial parameters, on
    the reference's batches: the first loss within 1e-5 relative, the rest
    within 1e-4.  Both compute in bf16 on f32 master weights and round at
    the same places; what remains is the reference's XLA keeping f32 in
    fused chains (excess precision), measured at 3e-6 on the first loss
    and 2.2e-5 on the others;
  * ``evaluate_quant`` on tiny-160k and tiny-650k with carried weights and
    the reference's ``eval_tokens``: perplexity within 1e-3 relative (the
    bar of test_torch_model.py), bits equal, the same optimal precision;
  * ``python -m repro_torch.paper.run --only fig2 --device cpu`` itself,
    with a shortened recipe on the two smallest models.
"""

import functools
import json
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
from repro.configs import QuantConfig as RQuantConfig  # noqa: E402
from repro.configs.registry import get_arch as r_get_arch  # noqa: E402
from repro.core import scaling_laws as rsl  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.quantize import bits_report as r_bits_report  # noqa: E402
from repro.models.quantize import dequantize_params as r_dequantize_params  # noqa: E402
from repro.models.quantize import quantize_params as r_quantize_params  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.serving import perplexity as r_perplexity  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import QuantConfig, get_arch  # noqa: E402
from repro_torch.core import scaling_laws as tsl  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.quantize import bits_report, quantize_params  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402
from repro_torch.paper import run as trun  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _rel(a, b) -> float:
    """max |a - b| over max |b|: the error relative to the values' scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


@pytest.mark.parametrize("vocab,rank,seed", [(2048, 16, 0), (300, 4, 7)])
def test_transition_logits_byte_identical(vocab, rank, seed):
    a = tsyn.make_transition_logits(vocab, rank, seed)
    b = rsyn.make_transition_logits(vocab, rank, seed)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_entropy_floor_matches_reference():
    port = tsyn.ZipfMarkov(2048, device="cpu").entropy_floor()
    ref = rsyn.ZipfMarkov(2048).entropy_floor()
    assert abs(port - ref) <= 1e-5 * ref, (port, ref)


def test_sampler_bigram_frequencies_follow_the_chain():
    vocab = 64
    proc = tsyn.ZipfMarkov(vocab, seed=3, device="cpu")
    toks = proc.sample(tsyn.generator(11, "cpu"), 4096, 257).long()
    assert toks.dtype == torch.int64 and tuple(toks.shape) == (4096, 257)
    probs = torch.softmax(torch.from_numpy(tsyn.make_transition_logits(vocab, seed=3)), -1)
    counts = torch.zeros((vocab, vocab), dtype=torch.float64)
    counts.index_put_((toks[:, :-1].reshape(-1), toks[:, 1:].reshape(-1)),
                      torch.ones(toks[:, 1:].numel(), dtype=torch.float64), accumulate=True)
    first = torch.bincount(toks[:, 0], minlength=vocab).double() / toks.shape[0]
    assert 0.5 * float((first - probs[0]).abs().sum()) < 0.05
    n_i = counts.sum(1)
    busy = n_i >= 20000
    assert int(busy.sum()) >= 5
    tv = 0.5 * (counts[busy] / n_i[busy, None] - probs[busy].double()).abs().sum(1)
    assert float(tv.max()) < 0.05, tv
    # the same generator seed gives the same sequences
    again = proc.sample(tsyn.generator(11, "cpu"), 4096, 257).long()
    assert torch.equal(toks, again)


def test_batches_resume_from_start_step():
    a = tsyn.batches(300, 4, 16, seed=2, device="cpu")
    first = [next(a) for _ in range(3)]
    b = next(tsyn.batches(300, 4, 16, seed=2, start_step=2, device="cpu"))
    assert b["step"] == 2 and torch.equal(b["tokens"], first[2]["tokens"])
    assert torch.equal(first[0]["tokens"][:, 1:], first[0]["labels"][:, :-1])


def test_cosine_lr_matches_reference():
    steps = np.arange(0, 300, dtype=np.int32)
    for warmup, total in ((50, 260), (1, 8), (10, 10)):
        ref = np.asarray(radamw.cosine_lr(jnp.asarray(steps), peak=3e-3, warmup=warmup,
                                          total=total))
        port = tadamw.cosine_lr(torch.from_numpy(steps), peak=3e-3, warmup=warmup,
                                total=total)
        assert port.dtype == torch.float32
        assert _rel(port.numpy(), ref) <= 1e-6


def test_adamw_update_matches_reference():
    rs = np.random.RandomState(0)
    params = {"stack": [{"w": rs.randn(2, 8, 6).astype(np.float32),
                         "scale": rs.randn(2, 8).astype(np.float32)}],
              "bias": rs.randn(6).astype(np.float32)}
    grads = [jax.tree.map(lambda p, i=i: (rs.randn(*p.shape) * (3.0 if i == 1 else 0.1))
                          .astype(np.float32), params) for i in range(3)]
    r_p, r_s = jax.tree.map(jnp.asarray, params), radamw.init(jax.tree.map(jnp.asarray, params))
    t_p = interop.params_from_reference(params, device="cpu")
    t_s = tadamw.init(t_p)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        r_p, r_s, r_gn = radamw.update(r_p, jax.tree.map(jnp.asarray, g), r_s, lr=lr)
        t_p, t_s, t_gn = tadamw.update(t_p, interop.params_from_reference(g, device="cpu"),
                                       t_s, lr=lr)
        assert _rel(float(t_gn), float(r_gn)) <= 1e-6
        assert int(t_s.step) == int(r_s.step) == i + 1
        for tree_t, tree_r in ((t_p, r_p), (t_s.m, r_s.m), (t_s.v, r_s.v)):
            for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_r)):
                assert a.dtype == torch.float32
                assert _rel(a.numpy(), b) <= 1e-6


@pytest.mark.parametrize("name,bits,dtype,block", [("tiny-160k", 4, "float", 64),
                                                   ("tiny-650k", 3, "int", 16),
                                                   ("qwen2-7b-reduced", 5, "dynamic", 32)])
def test_bits_report_equal_to_reference(name, bits, dtype, block):
    if name == "qwen2-7b-reduced":
        rcfg, tcfg = r_get_arch("qwen2-7b").reduced(), get_arch("qwen2-7b").reduced()
    else:
        rcfg, tcfg = r_get_arch(name), get_arch(name)
    raw = jax.jit(lambda k: rlm.init_params(k, rcfg))(jax.random.PRNGKey(1))
    ref = r_bits_report(jax.jit(lambda p: r_quantize_params(
        p, RQuantConfig(bits=bits, dtype=dtype, block_size=block), rcfg))(raw))
    port = bits_report(quantize_params(
        interop.params_from_reference(jax.tree.map(np.asarray, raw), device="cpu"),
        QuantConfig(bits=bits, dtype=dtype, block_size=block), tcfg, device="cpu"))
    assert port == ref


def test_scaling_laws_identical_to_reference():
    rs = np.random.RandomState(5)
    rows = [(n, 16.0 if k == 16 else k + 16 / 64, float(rs.rand() + 3), k)
            for n in (20_000, 300_000, 5_000_000) for k in (3, 4, 5, 6, 8, 16)]
    r_obs = [rsl.Observation(n, b, m, k) for n, b, m, k in rows]
    t_obs = [tsl.Observation(n, b, m, k) for n, b, m, k in rows]
    r_curves, t_curves = rsl.fit_curves(r_obs), tsl.fit_curves(t_obs)
    assert r_curves.keys() == t_curves.keys()
    for k in r_curves:
        np.testing.assert_array_equal(r_curves[k].log2_bits, t_curves[k].log2_bits)
        np.testing.assert_array_equal(r_curves[k].metric, t_curves[k].metric)
    for lower in (True, False):
        assert rsl.optimal_precision(r_curves, lower_is_better=lower) == \
            tsl.optimal_precision(t_curves, lower_is_better=lower)
        assert [(o.n_params, o.precision) for o in rsl.pareto_frontier(r_obs,
                                                                     lower_is_better=lower)] \
            == [(o.n_params, o.precision) for o in tsl.pareto_frontier(t_obs,
                                                                     lower_is_better=lower)]


N_STEPS, BATCH, SEQ = 8, 8, 64


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference's 8 jitted train steps of tiny-160k from PRNGKey(0),
    on its own batches: (initial params, batches, losses, grad norms)."""
    rcfg = r_get_arch("tiny-160k")
    state = rstep.init_state(jax.random.PRNGKey(0), rcfg)
    params0 = jax.tree.map(np.asarray, state.params)
    it = rsyn.batches(rcfg.vocab_size, BATCH, SEQ, seed=0)
    batches = [{k: np.asarray(b[k]) for k in ("tokens", "labels")}
               for b in (next(it) for _ in range(N_STEPS))]
    step = jax.jit(rstep.make_train_step(rcfg, peak_lr=3e-3, total_steps=N_STEPS,
                                         loss_chunk=SEQ))
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params0, batches, losses, norms


def _port_steps(microbatches=1):
    params0, batches, _, _ = _reference_run()
    p = interop.params_from_reference(params0, device="cpu")
    state = tstep.TrainState(params=p, opt=tadamw.init(p))
    step = tstep.make_train_step(get_arch("tiny-160k"), peak_lr=3e-3, total_steps=N_STEPS,
                                 loss_chunk=SEQ, microbatches=microbatches)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: _t(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def test_train_steps_match_reference():
    _, _, r_losses, r_norms = _reference_run()
    state, losses, norms = _port_steps()
    assert _rel(losses[0], r_losses[0]) <= 1e-5, (losses[0], r_losses[0])
    assert _rel(losses[1:], r_losses[1:]) <= 1e-4, (losses, r_losses)
    assert _rel(norms, r_norms) <= 1e-3, (norms, r_norms)
    assert losses[-1] < losses[0] and int(state.opt.step) == N_STEPS
    # gradient accumulation over two microbatches: the same mean gradient
    _, losses2, _ = _port_steps(microbatches=2)
    assert _rel(losses2, losses) <= 1e-4


def test_train_loop_runs_and_refuses_checkpoints(tmp_path):
    """Named when the loop refused ``ckpt_dir``; since checkpointing is
    ported, it saves there and a second call resumes from it (the resume's
    bit-exactness: test_torch_checkpoint.py)."""
    cfg = get_arch("tiny-160k")
    logs = []
    state, hist = tloop.train(cfg, steps=3, batch=2, seq_len=16, device="cpu",
                              log=logs.append, log_every=1)
    assert len(hist) == 3 and len(logs) == 3 and int(state.opt.step) == 3
    assert all(np.isfinite(hist))
    tloop.train(cfg, steps=2, batch=2, seq_len=16, device="cpu", ckpt_dir=str(tmp_path),
                log=lambda *_: None)
    logs = []
    state, tail = tloop.train(cfg, steps=3, batch=2, seq_len=16, device="cpu",
                              ckpt_dir=str(tmp_path), log=logs.append)
    assert logs[0].startswith("[resume] step 2") and len(tail) == 1
    assert int(state.opt.step) == 3


@functools.lru_cache(maxsize=None)
def _trained(name):
    """Weights trained a few steps by the port (so that quantization moves
    perplexity), as numpy for both packages."""
    state, _ = tloop.train(get_arch(name), steps=30, batch=8, seq_len=64, device="cpu",
                           log=lambda *_: None)
    return tree_map(lambda t: t.numpy(), state.params)


def _r_evaluate_quant(rcfg, params, qcfg, toks):
    """The reference's ``benchmarks.common.evaluate_quant``, with its
    quantization jitted and its perplexity read on the dequantized tree,
    which the reference computes identically (test_torch_model.py checks
    that substitution) and which shares one compilation per model."""
    if qcfg is None:
        return rcommon.evaluate_quant(rcfg, params, None, toks)
    qp = jax.jit(lambda p: r_quantize_params(p, qcfg, rcfg))(params)
    rep = r_bits_report(qp)
    return (r_perplexity(jax.jit(r_dequantize_params)(qp), rcfg, toks),
            rep["avg_bits_per_param"], rep["total_bits_ideal"])


def test_evaluate_quant_matches_reference():
    """The whole slice on the CPU: quantize, bits and perplexity per
    configuration, then the fitted optimal precision, in both packages."""
    configs = [(k, "float") for k in (3, 4, 8, 16)] + [(4, dt) for dt in
                                                        ("int", "dynamic", "quantile")]
    r_obs, t_obs = [], []
    for name in ("tiny-160k", "tiny-650k"):
        rcfg, tcfg = r_get_arch(name), get_arch(name)
        weights = _trained(name)
        r_params = jax.tree.map(jnp.asarray, weights)
        t_params = interop.params_from_reference(weights, device="cpu")
        toks = np.asarray(rcommon.eval_tokens(rcfg))
        for k, dt in configs:
            rq = None if k == 16 else RQuantConfig(bits=k, dtype=dt, block_size=64)
            tq = None if k == 16 else QuantConfig(bits=k, dtype=dt, block_size=64)
            r_ppl, r_bpp, r_tot = _r_evaluate_quant(rcfg, r_params, rq, jnp.asarray(toks))
            t_ppl, t_bpp, t_tot = tcommon.evaluate_quant(tcfg, t_params, tq, _t(toks))
            assert _rel(t_ppl, r_ppl) <= 1e-3, (name, k, dt, t_ppl, r_ppl)
            assert (t_bpp, t_tot) == (r_bpp, r_tot), (name, k, dt)
            if dt == "float":
                r_obs.append(rsl.Observation(rcfg.param_count(), r_bpp, float(np.log(r_ppl)), k))
                t_obs.append(tsl.Observation(tcfg.param_count(), t_bpp, float(np.log(t_ppl)), k))
    r_best = rsl.optimal_precision(rsl.fit_curves(r_obs))
    t_best = tsl.optimal_precision(tsl.fit_curves(t_obs))
    assert t_best["optimal_precision"] == r_best["optimal_precision"]


def test_paper_run_fig2_on_cpu(tmp_path, monkeypatch, capsys):
    """The entry point itself, shortened: two models, a few steps each."""
    monkeypatch.setattr(tcommon, "ART", tmp_path)
    trun.main(["--only", "fig2", "--device", "cpu", "--sizes", "tiny-160k,tiny-650k",
               "--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    names = [line.split(",")[0] for line in out[1:]]
    assert names == [f"fig2/{m}/k{k}" for m in ("tiny-160k", "tiny-650k")
                     for k in (3, 4, 5, 6, 8, 16)] + ["fig2/optimal_precision"]
    saved = json.loads((tmp_path / "bench_torch" / "fig2_bitlevel.json").read_text())
    assert len(saved["observations"]) == 12 and saved["optimal_precision"] in (3, 4, 5, 6, 8, 16)
    assert all(np.isfinite(o["log_ppl"]) for o in saved["observations"])
    with pytest.raises(SystemExit):
        trun.main(["--only", "fig9", "--device", "cpu"])


def test_paper_run_rest_on_cpu(tmp_path, monkeypatch, capsys):
    """fig4, appb and table1 through the entry point, shortened; a second
    call reads the cached ladder instead of training it."""
    monkeypatch.setattr(tcommon, "ART", tmp_path)
    argv = ["--only", "fig4,appb,table1", "--device", "cpu", "--sizes", "tiny-160k",
            "--steps", "5"]
    trun.main(argv)
    out = capsys.readouterr()
    names = [line.split(",")[0] for line in out.out.splitlines()[1:]]
    assert names == ([f"fig4/tiny-160k/{c}" for c in ("3bit", "3bit+proxy2%", "4bit",
                                                      "4bit+proxy2%")]
                     + ["fig4/proxy_helps_3bit_frac", "fig4/proxy3bit_beats_4bit_frac"]
                     + ["appb/tiny-160k/k4", "appb/tiny-160k/k8", "appb/mean_logppl_delta"]
                     + [f"table1/tiny-160k/b{b}" for b in (1024, 256, 64)]
                     + ["table1/tiny-160k/gptq3_noblock"])
    assert "[train] tiny-160k" in out.err
    fig4 = json.loads((tmp_path / "bench_torch" / "fig4_proxy.json").read_text())
    assert all(np.isfinite(v) for v in fig4["ppl"]["tiny-160k"].values())
    bits = fig4["bits"]["tiny-160k"]
    assert bits["3bit+proxy2%"] > bits["3bit"] and bits["4bit+proxy2%"] > bits["4bit"]
    appb = json.loads((tmp_path / "bench_torch" / "appb_centering.json").read_text())
    plain, centered = appb["models"]["tiny-160k"]["4"]["plain"], \
        appb["models"]["tiny-160k"]["4"]["centered"]
    assert centered[1] > plain[1] and np.isfinite(appb["mean_delta"])
    trun.main(["--only", "appb"] + argv[2:])
    out = capsys.readouterr()
    assert "[cache] tiny-160k" in out.err and "[train]" not in out.err
