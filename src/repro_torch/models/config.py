"""Architecture configuration.

One frozen dataclass describes every supported architecture family
(dense / moe / ssm / hybrid, with optional multimodal stub frontends).
The 10 assigned architectures instantiate this in ``repro/configs/``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (0 heads => attention-free)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp_type: str = "swiglu"          # swiglu | geglu | gelu
    qkv_bias: bool = False
    parallel_block: bool = False      # cohere-style parallel attn+ffn
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma-style sqrt(d_model) embed scaling
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_dense_ff: int = 0             # arctic: dense residual FFN width
    moe_capacity_factor: float = 1.25
    router_z_weight: float = 1e-3
    # dispatch groups: tokens are routed within groups aligned to the data
    # axis so the dispatch scatter stays shard-local (GSPMD-friendly MoE);
    # the effective group count is gcd(moe_groups, tokens)
    moe_groups: int = 16
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2): shared attention block cadence
    attn_every: int = 0
    # multimodal stub frontends
    frontend: str = "none"            # none | vision | audio
    num_patches: int = 0              # vision: precomputed patch embeddings
    audio_codebooks: int = 0
    # parallelism role of the mesh "model" axis for this arch:
    #   True  -> tensor parallelism (heads/ffn/experts sharded over "model")
    #   False -> "model" joins the batch axes (pure DP+FSDP; right choice for
    #            small archs or head counts that don't divide the axis)
    tensor_parallel: bool = True
    # attention-over-model: when TP is on but head counts don't divide the
    # model axis (arctic: 56 heads vs 16), run attention batch-parallel over
    # "model" (two activation reshards per layer) instead of letting GSPMD
    # all-gather the global batch (observed 1.5e15 B/step on arctic)
    attn_over_model: bool = False
    # gradient-accumulation dtype for the microbatch loop (bfloat16 halves
    # the accumulator: 480B params = 7.5 GiB/device in f32 vs 3.75 in bf16)
    accum_dtype: str = "float32"
    # chunked cross-entropy: bound the live (tokens, vocab) logits buffer by
    # computing CE in sequence chunks of this many tokens (0 = disabled)
    ce_chunk_tokens: int = 1024
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training
    optimizer: str = "adamw"          # adamw | adafactor | q8adam
    remat: str = "full"               # none | dots | full
    microbatches: int = 1             # grad-accumulation splits of the batch
    # attention lowering for long sequences (pure-JAX flash-style blocks)
    attn_block_q: int = 512
    attn_block_k: int = 1024
    attn_chunked_threshold: int = 4096   # use blocked attention at/above this S
    # sub-quadratic? (controls long_500k applicability)
    subquadratic: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def batch_axes(self) -> tuple[str, ...]:
        """Mesh axes the batch shards over (constrain() drops absent ones)."""
        return ("pod", "data") if self.tensor_parallel else ("pod", "data", "model")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        n = 0
        if self.frontend == "audio" and self.audio_codebooks:
            n += self.audio_codebooks * V * D          # codebook embeds
            n += self.audio_codebooks * V * D          # per-codebook heads
        else:
            n += V * D
            if not self.tie_embeddings:
                n += V * D
        if self.frontend == "vision":
            n += self.d_model * self.d_model           # patch projection stub
        per_layer = 0
        if self.family in ("dense", "moe"):
            per_layer += D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
            per_layer += 2 * D                          # norms
            gate = 2 if self.mlp_type in ("swiglu", "geglu") else 1
            if self.family == "dense":
                per_layer += (gate + 1) * D * F
            else:
                if self.moe_dense_ff:
                    per_layer += (gate + 1) * D * self.moe_dense_ff
                per_layer += self.moe_experts * (gate + 1) * D * F
                per_layer += D * self.moe_experts       # router
        elif self.family == "ssm":
            per_layer += self._mamba_block_params()
        elif self.family == "hybrid":
            per_layer += self._mamba_block_params()
        n += L * per_layer
        if self.family == "hybrid" and self.attn_every:
            # one shared attention+mlp block
            n += D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            n += 3 * D * self.d_ff + 2 * D
        n += D                                          # final norm
        return n

    def _mamba_block_params(self) -> int:
        D, DI, N = self.d_model, self.ssm_d_inner, self.ssm_state
        H = self.ssm_heads
        n = D * (2 * DI + 2 * N * (DI // self.ssm_head_dim and 1 or 1))  # placeholder
        # in_proj: D -> (z, x, B, C, dt) = 2*DI + 2*N*n_groups(=1) + H
        n = D * (2 * DI + 2 * N + H)
        n += self.ssm_conv * (DI + 2 * N)               # depthwise conv over x,B,C
        n += H * 2                                      # A_log, D per head
        n += DI                                         # pre-out norm (gated rmsnorm)
        n += DI * D                                     # out_proj
        n += D                                          # block norm
        return n

    def active_params_per_token(self) -> int:
        """MoE: params touched per token (top-k experts); dense: n_params."""
        if self.family != "moe":
            return self.n_params()
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        gate = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        n = V * D
        per_layer = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D + 2 * D
        if self.moe_dense_ff:
            per_layer += (gate + 1) * D * self.moe_dense_ff
        per_layer += self.moe_top_k * (gate + 1) * D * F
        per_layer += D * self.moe_experts
        return n + L * per_layer

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        vocab_size=256,
        microbatches=1,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 4) or 1,
                  head_dim=32, d_ff=256)
    if cfg.moe_experts:
        kw.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                  moe_capacity_factor=4.0)  # no token drops -> decode == forward
        if cfg.moe_dense_ff:
            kw.update(moe_dense_ff=128)
        kw.update(d_ff=128)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.num_patches:
        kw.update(num_patches=16)
    kw.update(attn_chunked_threshold=64, attn_block_q=32, attn_block_k=32)
    kw.update(param_dtype="float32", compute_dtype="float32")
    return cfg.with_overrides(**kw)
