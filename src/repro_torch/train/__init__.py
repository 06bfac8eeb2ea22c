from .step import StepBundle, TrainConfig, make_train_step

__all__ = ["StepBundle", "TrainConfig", "make_train_step"]
