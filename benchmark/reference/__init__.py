"""The plain reference of the benchmark's comparison: float32 PyTorch, no
kernel, no import of the program or of JAX.  ``model`` is the Conformer-CTC
forward, ``ops`` the log-mel, SpecAugment, CTC and the LSTM recurrence,
``optim`` the Adafactor update, ``judge`` the readings that decide
``correct``."""
