"""minitron-4b [arXiv:2407.14679; hf]: width/depth-pruned Nemotron.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000, tie_embeddings=True,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # train: pure DP/FSDP wins at global_batch >= chips (§Perf profile
    # search); serve shapes keep 2D (batch < chips)
    sharding_profile="dp", sharding_profile_serve="2d",
    train_accum_steps=2,  # only active on the 2-pod 2d fallback
)
