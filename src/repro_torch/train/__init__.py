from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm)
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.state import TrainState
from repro_torch.train.step import (make_decode_step, make_loss_fn,
                                    make_prefill_step, make_train_step)

__all__ = ["adamw_init", "adamw_update", "AdamWConfig", "global_norm",
           "warmup_cosine", "TrainState", "make_train_step", "make_loss_fn",
           "make_prefill_step", "make_decode_step"]
