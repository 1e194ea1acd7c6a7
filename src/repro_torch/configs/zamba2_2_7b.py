"""zamba2-2.7b [arXiv:2411.15242; hf]: Mamba2 backbone + shared attn block.

54 Mamba2 layers, d_model=2560, ssm_state=64; one weight-shared attention+
MLP block (32H, kv=32, d_ff=10240) applied every 6 layers.  vocab 32000.
Runs long_500k (hybrid).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # train: pure DP/FSDP wins at global_batch >= chips (§Perf profile
    # search); serve shapes keep 2D (batch < chips)
    sharding_profile="dp", sharding_profile_serve="2d",
)
