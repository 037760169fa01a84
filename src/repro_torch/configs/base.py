"""Config dataclasses: architecture, quantization, and input shapes — a copy
of ``repro/configs/base.py``.

Every assigned architecture is an ``ArchConfig`` instance in its own
module under ``repro/configs/``; the paper's quantization technique is a
first-class ``QuantConfig`` attached at launch time (``--quant``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavor
    rope_theta: float = 1e4
    qkv_bias: bool = False           # qwen2
    qk_norm: bool = False            # chameleon
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma2: 2 -> alternating local/global
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    post_block_norm: bool = False    # gemma2 sandwich norms
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1              # MoE every `moe_period` layers, rest dense MLP
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM / hybrid
    attn_period: int = 1             # 1: all-attn; 0: attn-free; 8: jamba 1-in-8
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256             # SSD chunk length

    # encoder-decoder (seamless-m4t)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    decoder_cache_len: int = 4096    # self-attn cache budget for decode shapes

    # modality frontend: tokens, or precomputed frame/patch embeddings (stub)
    input_kind: str = "tokens"       # tokens | frames

    dtype: str = "bfloat16"

    # KV-cache quantization — a serving-time knob, not an architecture
    # property (set it via with_kv_quant() at launch; the arch name is
    # unchanged).  16 keeps the dense bf16 cache; 8/4 store each cached
    # token as packed k-bit codes + per-block absmax scales, the same
    # blockwise machinery as the weights (docs/quantization.md#the-k-bit-
    # quantized-kv-cache).  Blocks run along the per-token feature dim
    # (n_kv_heads * head_dim), clamped to it when smaller.
    kv_bits: int = 16                # 16 (bf16 cache) | 8 | 4
    kv_block_size: int = 64
    kv_dtype: str = "float"          # int | float | dynamic (not quantile)
    # (The reference's kv_use_kernel opt-in has no counterpart: a CUDA cache
    # is always read through the kernel, a CPU cache through its plain version.)

    # Weight-matmul dispatch for QuantizedTensor weights
    # (docs/quantization.md#the-fused-dequant-gemm-serving-path):
    #   "dequant_einsum" — materialize the 16-bit dequant transient, einsum
    #                      (the original hot path; also the numerical oracle)
    #   "fused"          — packed codes + per-block scales go straight into
    #                      the fused dequant-GEMM (the CUDA kernel on the
    #                      card, its plain version on CPU); QTs the
    #                      kernel layout cannot express (centering means,
    #                      proxy outliers, flat odd-shape storage) fall back
    #                      to dequant_einsum per matrix
    #   "auto"           — resolve per matrix: fused wherever eligible
    matmul_mode: str = "auto"        # auto | fused | dequant_einsum

    # ---- derived ------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.attn_period == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: never materializes O(seq) full-attn KV.

        True when every attention layer is windowed or there is no
        attention at all; hybrid counts because its rare attention layers
        carry a seq-sharded linear-cost cache (models/sharding.py).
        """
        if self.is_attention_free:
            return True
        if self.family == "hybrid":
            return True
        if self.sliding_window > 0 and self.local_global_period == 0:
            return True  # SWA everywhere (danube)
        return False

    def layer_schedule(self) -> list[tuple[str, str]]:
        """(mixer, ffn) per layer. mixer: attn|attn_local|attn_global|ssm."""
        specs = []
        for i in range(self.n_layers):
            if self.attn_period == 0:
                mixer = "ssm"
            elif self.attn_period == 1:
                if self.local_global_period:
                    mixer = (
                        "attn_local"
                        if i % self.local_global_period == 0
                        else "attn_global"
                    )
                else:
                    mixer = "attn"
            else:
                mixer = "attn" if i % self.attn_period == 0 else "ssm"
            if self.n_experts and i % self.moe_period == (self.moe_period - 1):
                ffn = "moe"
            else:
                ffn = "mlp"
            specs.append((mixer, ffn))
        return specs

    def scan_period(self) -> int:
        """Smallest p with schedule[i] == schedule[i % p]; layers are scanned
        as n_layers/p stacked periods of p heterogeneous positions."""
        sched = self.layer_schedule()
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p == 0 and all(
                sched[i] == sched[i % p] for i in range(self.n_layers)
            ):
                return p
        return self.n_layers

    def param_count(self) -> int:
        """Exact parameter count of the implemented model."""
        from repro_torch.models.lm import count_params  # lazy: avoid cycle

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.lm import count_params

        return count_params(self, active_only=True)

    def with_kv_quant(self, bits: int, *, block_size: int | None = None,
                      dtype: str | None = None) -> "ArchConfig":
        """Same arch with a k-bit KV cache. bits=16 restores the bf16 cache."""
        if bits not in (4, 8, 16):
            raise ValueError(f"kv_bits must be 4, 8 or 16, got {bits}")
        kv_dtype = dtype if dtype is not None else self.kv_dtype
        if kv_dtype == "quantile":
            raise ValueError(
                "quantile codebooks are data-dependent; the streaming "
                "append-quantize needs a static codebook (int/float/dynamic)"
            )
        return dataclasses.replace(
            self,
            kv_bits=bits,
            kv_block_size=block_size if block_size is not None else self.kv_block_size,
            kv_dtype=kv_dtype,
        )

    def with_matmul_mode(self, mode: str) -> "ArchConfig":
        """Same arch with a different QuantizedTensor matmul dispatch."""
        if mode not in ("auto", "fused", "dequant_einsum"):
            raise ValueError(
                f"matmul_mode must be auto | fused | dequant_einsum, got {mode!r}"
            )
        return dataclasses.replace(self, matmul_mode=mode)

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test-sized config of the same family (small dims, same
        structural features). Exercised by per-arch smoke tests on CPU."""
        sched_period = self.scan_period()
        n_layers = max(2 * sched_period, sched_period)
        base = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            sliding_window=16 if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            n_encoder_layers=2 if self.encoder_decoder else 0,
            decoder_cache_len=32,
            name=self.name + "-smoke",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class QuantConfig:
    """The paper's technique as a launch-time feature (§2.2-§3)."""

    bits: int = 4
    dtype: str = "float"             # int | float | dynamic | quantile
    block_size: int = 64
    exponent_bits: Optional[int] = None  # None -> paper defaults (App. A)
    centering: bool = False          # App. B (negative result)
    outlier_pct: float = 0.0         # proxy quantization (§3), e.g. 0.02
    quantize_embedding: bool = False
    quantize_lm_head: bool = True

    def describe(self) -> str:
        s = f"{self.dtype}{self.bits}-b{self.block_size}"
        if self.centering:
            s += "-cent"
        if self.outlier_pct:
            s += f"-ol{self.outlier_pct:g}"
        return s


#: sentinel: no quantization (the paper's 16-bit baseline)
FP16 = None


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Which (arch x shape) cells run; the reason string documents skips."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (full-attn arch)"
    if (
        shape.name == "long_500k"
        and arch.encoder_decoder
    ):
        return False, "500k decoder cache not meaningful for speech enc-dec"
    return True, ""
