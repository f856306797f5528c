"""Port's LSTM twin vs the JAX Pallas LSTM kernel in interpret mode.

Tolerance atol 1e-5, as test_pallas.py's kernel-vs-scan check: both sides
run the same float32 recurrence, summed in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.ops.pallas.lstm import lstm_pallas
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.lstm import lstm, lstm_plain

ATOL = 1e-5


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize(
    "hidden, lengths",
    [(8, [7, 3, 7, 1]), (160, [6, 4, 6])],  # 160 > 128: spans lane tiles on the TPU side
)
def test_lstm_matches_pallas_interpret(rng, reverse, hidden, lengths):
    b, t = len(lengths), max(lengths)
    xw = rng.standard_normal((b, t, 4 * hidden)).astype(np.float32) * 0.5
    wh = rng.standard_normal((hidden, 4 * hidden)).astype(np.float32) * hidden ** -0.5
    lens = np.asarray(lengths, np.int32)
    ref = lstm_pallas(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(lens), reverse=reverse, interpret=True)
    got = lstm(torch.from_numpy(xw), torch.from_numpy(wh), torch.from_numpy(lens), reverse=reverse)
    assert got.shape == (b, t, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_lstm_padded_steps_carry_h(rng):
    """Padded steps emit the carried h; the reverse direction starts at each
    row's own len-1, so a row's valid outputs ignore its padding."""
    xw = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32))
    wh = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32) * 0.5)
    lens = torch.tensor([6, 3])
    fwd = lstm_plain(xw, wh, lens)
    torch.testing.assert_close(fwd[1, 3:], fwd[1, 2:3].expand(3, 4))
    bwd = lstm_plain(xw, wh, lens, reverse=True)
    torch.testing.assert_close(bwd[1, 3:], torch.zeros(3, 4))
    alone = lstm_plain(xw[1:, :3], wh, torch.tensor([3]), reverse=True)
    torch.testing.assert_close(bwd[1:, :3], alone)
