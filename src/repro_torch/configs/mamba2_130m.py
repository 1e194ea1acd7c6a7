"""mamba2-130m [arXiv:2405.21060; unverified]: SSD, attention-free.

24L d_model=768 ssm_state=128; d_inner = 2*d_model, head_dim 64 (24 heads).
Runs long_500k (O(1) decode state).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,  # attn unused
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # <1B params: pure DP/FSDP beats 2D sharding at 256 chips (§Perf)
    sharding_profile="dp", sharding_profile_serve="2d",
    train_accum_steps=2,  # only active on the 2-pod 2d fallback
)
