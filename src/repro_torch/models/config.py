"""Model and shape configuration dataclasses.

A copy of ``repro.models.config`` (same fields, defaults and properties,
so a config means the same model in both packages).  One
:class:`ModelConfig` per architecture (see ``repro_torch.configs``), one
:class:`ShapeConfig` per assigned input-shape cell.  ``use_flash`` picks
the prefill attention (kernel 1, or the dense score matrix when off);
``remat`` and ``remat_policy`` set ``forward``'s activation
checkpointing; execution fields the port does not read (the sharding
profiles, ``attn_chunk_*``, ``train_accum_steps``) are kept as data.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # attention pattern
    sliding_window: int = 0     # 0 = full attention everywhere
    global_every: int = 0       # gemma3: every Nth layer is global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (zamba2): one *shared* attention block applied every N layers
    attn_every: int = 0
    # modality frontend (stub): precomputed patch/frame embeddings
    frontend: str = ""          # "" | "vision" | "audio"
    frontend_prefix_len: int = 0
    frontend_dim: int = 0       # raw embedding dim before projection
    # numerics / execution
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "full"   # full | dots (save matmul outputs)
    sharding_profile: str = "2d"  # 2d (FSDP x TP) | dp (pure DP/FSDP) | sp
    sharding_profile_serve: str = ""  # override for prefill/decode ("" = same)
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    use_flash: bool = True      # chunked (flash) attention vs dense scores
    train_accum_steps: int = 1  # microbatching (keeps big models in HBM)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def ssm_groups(self) -> int:
        return 1

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (see DESIGN.md §4)."""
        return (self.family in ("ssm", "hybrid")
                or (self.sliding_window > 0 and self.global_every > 0))

    def n_params(self) -> float:
        """Total parameter count (embedding included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.n_experts:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp = 3 * d * f
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, g, n, h = (self.d_inner, self.ssm_groups, self.ssm_state,
                           self.ssm_heads)
            proj = d * (2 * di + 2 * g * n + h) + di * d
            conv = self.ssm_conv * (di + 2 * g * n)
            ssm = proj + conv + 3 * h + di
        per_layer = 2 * d  # norms
        if self.family == "ssm":
            per_layer += ssm
        elif self.family == "hybrid":
            per_layer += ssm
            n_attn = self.n_layers // max(self.attn_every, 1)
            emb += (attn + mlp + 2 * d)  # one shared block
            return emb + self.n_layers * per_layer + 2 * d
        else:
            per_layer += attn + mlp
        return emb + self.n_layers * per_layer + 2 * d

    def n_active_params(self) -> float:
        """Active parameters per token (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_equiv = dataclasses.replace(self, n_experts=0, top_k=0)
        base = dense_equiv.n_params() - self.n_layers * 3 * d * f
        return base + self.n_layers * (self.top_k * 3 * d * f
                                       + d * self.n_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if not cfg.n_experts else 32,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=8,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        global_every=min(cfg.global_every, 2) if cfg.global_every else 0,
        attn_every=2 if cfg.attn_every else 0,
        frontend_prefix_len=min(cfg.frontend_prefix_len, 4)
        if cfg.frontend else 0,
        frontend_dim=32 if cfg.frontend else 0,
        attn_chunk_q=8, attn_chunk_kv=8,
        param_dtype="float32", act_dtype="float32", remat=False,
    )
