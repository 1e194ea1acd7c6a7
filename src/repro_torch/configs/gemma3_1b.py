"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified]: 5:1 local:global.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; sliding window 1024
on local layers, full attention every 6th layer; head_dim 256; tied
embeddings; 128k context (sub-quadratic => runs long_500k).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    sliding_window=1024, global_every=6, tie_embeddings=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # <1B params: pure DP/FSDP beats 2D sharding at 256 chips (§Perf)
    # train: pure DP/FSDP (batch 256 covers the pod); prefill/decode:
    # 2D — batch 32 cannot cover 256 chips data-parallel (§Perf)
    sharding_profile="dp", sharding_profile_serve="2d",
    train_accum_steps=2,  # only active on the 2-pod 2d fallback
)
