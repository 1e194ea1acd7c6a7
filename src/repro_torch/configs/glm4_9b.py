"""glm4-9b [hf:THUDM/glm-4-9b; hf]: RoPE + aggressive GQA (kv=2).

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # train: pure DP/FSDP wins at global_batch >= chips (§Perf profile
    # search); serve shapes keep 2D (batch < chips)
    sharding_profile="dp", sharding_profile_serve="2d",
)
