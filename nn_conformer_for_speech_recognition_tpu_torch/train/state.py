"""Train state, port of `nn_conformer_for_speech_recognition_tpu/train/state.py`.

The JAX state is an immutable pytree of params, batch stats, optimizer
state, step and PRNG key.  Here the module holds its parameters and batch
statistics, and the optimizer its own state; `TrainState` groups them with
the step count, the seed that dropout is drawn from, and an explicit
``torch.Generator`` on the model's device for the SpecAugment draws and
the waveform noise.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Union

import torch

from nn_conformer_for_speech_recognition_tpu_torch.train.optim import Adafactor, Adam


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Union[Adafactor, Adam]
    generator: torch.Generator
    seed: int
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Union[Adafactor, Adam], seed: int) -> "TrainState":
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(model=model, optimizer=optimizer, generator=generator, seed=seed)

    def __deepcopy__(self, memo) -> "TrainState":
        """An independent copy on the same device: the optimizer's copy
        refers to the model's copy, and the generator's copy continues the
        same stream."""
        generator = torch.Generator(device=self.generator.device)
        generator.set_state(self.generator.get_state())
        return TrainState(
            model=copy.deepcopy(self.model, memo), optimizer=copy.deepcopy(self.optimizer, memo),
            generator=generator, seed=self.seed, step=self.step,
        )

    def dropout_seed(self, rank: int = 0) -> int:
        """Seed of the device generator for this step's dropout masks: a
        step repeated from the same state draws the same masks.  ``rank``
        (data parallelism) is folded in, so that each rank draws its own
        masks for its rows; rank 0 draws a single process's."""
        seed = (self.seed * 1_000_003 + self.step) % (2 ** 63)
        return seed if rank == 0 else (seed * 1_000_003 + rank) % (2 ** 63)

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``."""
        self.optimizer.step()
        self.step += 1
