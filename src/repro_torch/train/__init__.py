"""Training: AdamW, remat policies, the train step, gradient compression,
compressed checkpoints and the fault-tolerant loop (the reference's
``train/``)."""
