from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.training.train_step import TrainConfig, make_loss_fn, make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "TrainConfig",
           "make_loss_fn", "make_train_step"]
