"""PyTorch/CUDA port of the Conformer ASR framework.

A second package beside the JAX reference
(`nn_conformer_for_speech_recognition_tpu/`), with the same file layout so
each counterpart is easy to find.  It imports ``torch`` and never ``jax``:
the framework-free pieces of the reference (config dataclasses, filterbank
helpers, rel-pos table, word vocabulary) are copied, and tests hold each copy
equal to its original.

The slice ported so far is the Noisy Student pseudo-label pass
(``train.loop.make_predict_step``): log-mel featurisation → ConformerCTC
forward in eval mode → greedy decode.  Its three hand-written Hopper kernels
live in ``ops/cuda/`` (sources in ``csrc/``) and are built with ``nvcc`` at
first use; on a CPU tensor every kernel wrapper runs its plain PyTorch twin.
"""

__version__ = "0.1.0"
