from .optimizers import Optimizer, adamw, apply_updates, sgd
from .schedule import constant, warmup_cosine
