"""granite-moe-3b-a800m [hf:ibm-granite family; hf]: fine-grained MoE.

32L d_model=1536 24H (GQA kv=8), 40 experts (d_ff=512 each) top-8,
vocab 49155.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8, capacity_factor=1.25,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # train: pure DP/FSDP wins at global_batch >= chips (§Perf profile
    # search); serve shapes keep 2D (batch < chips)
    sharding_profile="dp", sharding_profile_serve="2d",
    train_accum_steps=2,  # only active on the 2-pod 2d fallback
)
