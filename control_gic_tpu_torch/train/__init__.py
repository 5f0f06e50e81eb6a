"""Training: losses, state and the fused generator + discriminator step."""
from .losses import LossConfig, hinge_d_loss, vanilla_d_loss
from .state import TrainConfig, TrainState, create_train_state
from .step import Trainer
