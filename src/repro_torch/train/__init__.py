"""The training path (port of ``repro.train``): optimizers, synthetic
data, the training step, checkpoints, gradient compression and the
fault-tolerant trainer, on the port's models and kernels."""

from repro_torch.train import checkpoint
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.optim import adam, adamw, sgd
from repro_torch.train.train_step import TrainState, init_state, make_train_step
