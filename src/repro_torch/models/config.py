"""ModelConfig — one dataclass describes every architecture in the zoo
(a copy of ``repro/models/config.py``, so configs copy verbatim).

Families:
  dense   — standard decoder (GQA/MQA attention + gated MLP)
  moe     — dense attention + mixture-of-experts MLP
  mla     — multi-head latent attention (MiniCPM3 / DeepSeek-style)
  ssm     — attention-free Mamba-2 (SSD) stack
  hybrid  — parallel attention + SSM heads per block (Hymba)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | mla | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int

    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    window: Optional[int] = None      # sliding-window size (SWA) or None
    rope_theta: float = 10_000.0

    # ---- mlp ----
    d_ff: int = 0
    act: str = "swiglu"               # swiglu | geglu

    # ---- moe ----
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ---- mla (minicpm3 / deepseek style) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- ssm (mamba2 / SSD) ----
    d_inner: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssm_chunk: int = 128

    # ---- embeddings ----
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma: scale embeddings by sqrt(d)

    # ---- norm / numerics ----
    rms_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    score_dtype: str = "float32"    # attention score pipeline ("bfloat16"
                                    # halves the dominant HBM traffic; the
                                    # m/l softmax stats stay f32)

    # ---- modality frontend stub ----
    frontend: Optional[str] = None    # "vision" | "audio" | None
    n_prefix_embeds: int = 0          # patch/frame embeddings fed directly

    # ---- runtime knobs (not architecture) ----
    use_pallas: bool = False
    q_block: int = 512
    kv_block: int = 512
    remat: str = "nothing"            # nothing | dots | none
    attn_impl: str = "auto"           # auto | blockwise | banded

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- derived
    @property
    def q_dim(self) -> int:
        if self.family == "mla":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "mla", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (bounded cache)."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.window is not None) or (
            self.window is not None)

    def cache_len(self, seq_len: int) -> int:
        """Allocated KV-cache length for a given context length."""
        if self.window is not None:
            return min(self.window, seq_len)
        return seq_len

    # ------------------------------------------------------------- counts
    def param_count(self) -> int:
        """Exact parameter count (matches init_params)."""
        d, V = self.d_model, self.vocab
        total = V * d                         # input embedding
        if not self.tie_embeddings:
            total += d * V                    # lm head
        total += d                            # final norm
        per_layer = 0
        if self.family in ("dense", "moe", "hybrid"):
            per_layer += 2 * d                # attn norm + mlp norm
            if self.family == "hybrid":
                per_layer += 2 * d            # fusion norms
        if self.family == "mla":
            per_layer += 2 * d
        if self.has_attention and self.family != "mla":
            per_layer += d * self.q_dim + 2 * d * self.kv_dim \
                + self.q_dim * d
        if self.family == "mla":
            qr, kr = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vh = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
            H = self.n_heads
            per_layer += d * qr + qr + qr * H * (nope + rope)      # q path
            per_layer += d * (kr + rope) + kr                      # kv compress
            per_layer += kr * H * (nope + vh)                      # kv expand
            per_layer += H * vh * d                                # out proj
        if self.has_ssm:
            di, N, G, Hs = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
            conv_ch = di + 2 * G * N
            per_layer += d * (2 * di + 2 * G * N + Hs)             # in_proj
            per_layer += conv_ch * self.conv_kernel + conv_ch      # conv
            per_layer += Hs * 3                                    # A_log, D, dt_bias
            per_layer += di                                        # gated norm
            per_layer += di * d                                    # out_proj
            if self.family == "ssm":
                per_layer += d                                     # block norm
        if self.is_moe:
            per_layer += d * self.n_experts                        # router
            per_layer += self.n_experts * 3 * d * self.d_ff_expert
        elif self.family in ("dense", "mla", "hybrid"):
            per_layer += 3 * d * self.d_ff
        return total + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) \
            * 3 * self.d_model * self.d_ff_expert
        return self.param_count() - inactive
