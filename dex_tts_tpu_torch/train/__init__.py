from dex_tts_tpu_torch.train.checkpoint import CheckpointManager
from dex_tts_tpu_torch.train.preemption import PreemptionGuard
from dex_tts_tpu_torch.train.state import TrainState, create_train_state
from dex_tts_tpu_torch.train.trainer import Trainer, make_train_step, make_valid_step

__all__ = [
    "CheckpointManager",
    "PreemptionGuard",
    "TrainState",
    "Trainer",
    "create_train_state",
    "make_train_step",
    "make_valid_step",
]
