"""Training and evaluation: metrics, learning-rate schedules, the train step
(``trainer``, with the on-device augmentation of ``augment``) and
train-time validation. The fit loop and checkpoints wait for the checkpoint
slice."""
