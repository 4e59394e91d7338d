"""The plain reference of the benchmark: M1 in plain PyTorch, the draws'
rules, the augmentation, the loss and the optimizer, and the comparison
that decides ``correct``. It imports nothing of the program and nothing of
JAX; the program's published conventions it follows are frozen copies here."""
