"""Model substrate of the port: every family of the reference's LM zoo
(dense, moe, ssm, hybrid, vlm, audio), with the configs and layers they
need."""

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES
from repro_torch.models.transformer import (LMParams, init_params, forward,
                                            init_decode_state, prefill,
                                            decode_step)
