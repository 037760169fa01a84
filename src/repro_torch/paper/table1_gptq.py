"""Table 1 + Figure 5: one-shot GPTQ against zero-shot float quantization —
port of ``benchmarks/table1_gptq.py``.

Full-model SEQUENTIAL GPTQ on the dense tiny models: each layer's inputs are
captured from the already partially quantized forward pass, each weight
matrix gets Hessian-guided rounding (``core/gptq.py``, float64 on the
weights' device), and held-out perplexity is compared against zero-shot
float at matched bits.

Paper claims reproduced:
  * 2-bit GPTQ + small blocks beats zero-shot 3-bit float  (Table 1)
  * GPTQ *needs* blocking: unblocked low-bit GPTQ scales poorly (Fig. 5)
"""

from __future__ import annotations

import torch

from repro_torch.configs import QuantConfig
from repro_torch.core import gptq
from repro_torch.core.codebooks import make_codebook
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import activation, dense, norm
from repro_torch.paper import common
from repro_torch.serving import perplexity
from repro_torch.tree import leaves, tree_map

#: the reference's models; a family holding neither (a ``--sizes`` run)
#: runs on every model it holds
SIZES = ("tiny-650k", "tiny-2.6m")
BLOCKS = (1024, 256, 64)


def _gptq_model(cfg, params, calib_tokens, *, bits, block_size):
    """Sequential GPTQ over a dense llama-style stack.  Returns a params tree
    with dequantized (noise-lens) GPTQ weights in f32, as the reference
    stores them back into its f32 stack."""
    dev = leaves(params)[0].device
    cb = make_codebook("int", bits, device=dev)
    calib_tokens = torch.as_tensor(calib_tokens, device=dev)
    x = params["embed"].to(torch.bfloat16)[calib_tokens]
    positions = torch.arange(calib_tokens.shape[1], dtype=torch.int32, device=dev)
    stack = params["stack"][0]
    new_stack = tree_map(torch.clone, stack)

    def q(w, x_in):
        X = x_in.to(torch.float32).reshape(-1, w.shape[0])
        H = gptq.hessian_from_inputs(X)
        return gptq.gptq_quantize(w, H, cb, block_size=block_size).to(torch.float32)

    def new(part, name, layer):
        return {"w": new_stack[part][name]["w"][layer]}

    for layer in range(cfg.n_layers):
        p = tree_map(lambda a: a[layer], stack)
        h = norm(p["mixer_norm"], x, cfg.norm_type)
        for name in ("wq", "wk", "wv"):
            new_stack["mixer"][name]["w"][layer] = q(p["mixer"][name]["w"], h)
        # recompute q/k/v with QUANTIZED weights (sequential error propagation)
        pq = {k: new("mixer", k, layer) for k in ("wq", "wk", "wv")}
        pq["wo"] = p["mixer"]["wo"]
        if cfg.qkv_bias:
            for k in ("wq", "wk", "wv"):
                pq[k]["b"] = p["mixer"][k].get("b")
        B, S, _ = h.shape
        qh, kh, vh = attn_mod.project_qkv({**p["mixer"], **pq}, h, cfg, positions)
        o = attn_mod.flash_attention(qh, kh, vh, causal=True, window=cfg.sliding_window)
        o = o.reshape(B, S, -1)
        new_stack["mixer"]["wo"]["w"][layer] = q(p["mixer"]["wo"]["w"], o)
        x = x + dense(new("mixer", "wo", layer), o)

        h2 = norm(p["ffn_norm"], x, cfg.norm_type)
        new_stack["ffn"]["w_gate"]["w"][layer] = q(p["ffn"]["w_gate"]["w"], h2)
        new_stack["ffn"]["w_up"]["w"][layer] = q(p["ffn"]["w_up"]["w"], h2)
        hid = activation(dense(new("ffn", "w_gate", layer), h2), cfg.act) \
            * dense(new("ffn", "w_up", layer), h2)
        new_stack["ffn"]["w_down"]["w"][layer] = q(p["ffn"]["w_down"]["w"], hid)
        x = x + dense(new("ffn", "w_down", layer), hid)

    return {**params, "stack": [new_stack]}


def run(family, log=print):
    """``family``: ``common.trained_family``'s {name: Trained}; runs on its
    models in SIZES.  Returns the rows and {model: {block: {"gptq2",
    "float3"}, "gptq3_noblock": perplexity}}."""
    chosen = {n: t for n, t in family.items() if n in SIZES} or family
    rows = []
    table = {}
    for name, t in chosen.items():
        cfg, params = t.cfg, t.params
        dev = leaves(params)[0].device
        toks = common.eval_tokens(cfg, device=dev)
        calib = common.eval_tokens(cfg, n_seqs=8, seed=777, device=dev)[:, :128]
        entry = {}
        for bs in BLOCKS:
            ppl_gptq2 = perplexity(_gptq_model(cfg, params, calib, bits=2, block_size=bs),
                                   cfg, toks, device=dev)
            ppl_f3, _, _ = common.evaluate_quant(
                cfg, params, QuantConfig(bits=3, dtype="float", block_size=bs), toks)
            entry[bs] = {"gptq2": ppl_gptq2, "float3": ppl_f3}
            rows.append((f"table1/{name}/b{bs}", 0.0,
                         f"gptq2={ppl_gptq2:.3f};float3={ppl_f3:.3f}"))
            log(f"  {name} block={bs:<5d} 2-bit GPTQ {ppl_gptq2:8.3f} "
                f"vs 3-bit float {ppl_f3:8.3f}")
        # Fig 5: unblocked GPTQ at 3-bit vs blocked zero-shot float-3
        ppl_gptq3_nb = perplexity(_gptq_model(cfg, params, calib, bits=3, block_size=None),
                                  cfg, toks, device=dev)
        ppl_f3_b64 = entry[64]["float3"]
        entry["gptq3_noblock"] = ppl_gptq3_nb
        rows.append((f"table1/{name}/gptq3_noblock", 0.0,
                     f"{ppl_gptq3_nb:.3f};float3_b64={ppl_f3_b64:.3f}"))
        log(f"  {name} 3-bit GPTQ no-block {ppl_gptq3_nb:.3f} vs "
            f"3-bit float b64 {ppl_f3_b64:.3f}")
        table[name] = entry
    common.save_json("table1_gptq", table)
    return rows, table
