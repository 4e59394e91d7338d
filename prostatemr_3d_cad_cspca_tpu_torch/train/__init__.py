"""Training and evaluation: metrics, learning-rate schedules, the train step
(``trainer``) and train-time validation. The fit loop and checkpoints wait
for the data slice."""
