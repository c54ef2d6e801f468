from .train_state import ADMMTrainState, SGDTrainState
from .trainer import ADMMTrainer, SGDTrainer
