from .optim import build_optimizer, cyclic_triangular2
from .steps import make_train_step, make_eval_step, init_state
from .dvclive_io import MetricsWriter
from .checkpoint import CheckpointManager
from .trainer import Trainer
