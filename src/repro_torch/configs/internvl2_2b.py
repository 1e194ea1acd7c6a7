"""internvl2-2b [arXiv:2404.16821; hf]: InternViT + InternLM2 backbone.

LM backbone only (per assignment): 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553.  The InternViT frontend is a STUB: ``input_specs``
provides precomputed patch embeddings (256 tokens x 1024 dims).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    frontend="vision", frontend_prefix_len=256, frontend_dim=1024,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # train: pure DP/FSDP wins at global_batch >= chips (§Perf profile
    # search); serve shapes keep 2D (batch < chips)
    sharding_profile="dp", sharding_profile_serve="2d",
    train_accum_steps=2,  # used on the 2-pod 2d fallback
)
