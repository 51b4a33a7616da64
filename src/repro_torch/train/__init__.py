"""Training: AdamW, remat policies, the train step, gradient compression,
compressed checkpoints and the fault-tolerant loop (the reference's
``train/``)."""
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_dp_compressed_step, make_train_step

__all__ = ["AdamWConfig", "make_dp_compressed_step", "make_train_step"]
