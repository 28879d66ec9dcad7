from repro_torch.train.optimizer import adamw, adafactor, cosine_schedule, OPTIMIZERS
from repro_torch.train.train_step import (TrainStepConfig, init_train_state, load_train_state,
                                          make_train_step)
from repro_torch.train.checkpoint import CheckpointManager
