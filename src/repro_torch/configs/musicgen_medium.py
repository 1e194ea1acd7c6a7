"""musicgen-medium [arXiv:2306.05284; hf]: decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 => effectively MHA) d_ff=6144 vocab=2048.
The EnCodec/text-conditioning frontend is a STUB: ``input_specs`` provides
precomputed conditioning frame embeddings (see DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    frontend="audio", frontend_prefix_len=64, frontend_dim=768,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # train: pure DP/FSDP wins at global_batch >= chips (§Perf profile
    # search); serve shapes keep 2D (batch < chips)
    sharding_profile="dp", sharding_profile_serve="2d",
)
