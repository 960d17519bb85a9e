from repro_torch.optim.adamw import (TrainState, adamw_init, adamw_update,
                                     cosine_schedule, make_train_step)

__all__ = ["TrainState", "adamw_init", "adamw_update", "cosine_schedule",
           "make_train_step"]
