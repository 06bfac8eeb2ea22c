from .step import (StepBundle, TrainConfig, make_decode_step,
                   make_prefill_step, make_train_step)

__all__ = ["StepBundle", "TrainConfig", "make_decode_step",
           "make_prefill_step", "make_train_step"]
