"""The benchmark of the PyTorch and CUDA port (``*_torch``): cells of a model
configuration under a traffic mix, run end to end through the port's
``Trainer``; see ``README.md``.  Nothing here imports JAX or the JAX package."""
