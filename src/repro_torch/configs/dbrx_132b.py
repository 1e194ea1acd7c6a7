"""dbrx-132b [hf:databricks/dbrx-base; unverified]: 16-expert top-4 MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 per expert, vocab 100352.
132B total / ~36B active parameters.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, capacity_factor=1.25,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    # 1M tokens/step on 256 chips: 4 microbatches keep residency in HBM
    train_accum_steps=8,
)
