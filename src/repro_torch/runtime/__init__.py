"""The fault-tolerant trainer and its straggler monitor."""

from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
