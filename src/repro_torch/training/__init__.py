from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.data import DataConfig, MarkovLM, batches
from repro_torch.training.trainer import Trainer, make_train_step
