"""Greedy CTC decoding, port of
`nn_conformer_for_speech_recognition_tpu/ops/decode.py:greedy_decode` and
``collapse_repeats``.  Beam search is not ported yet."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def greedy_decode(
    log_probs: torch.Tensor, frame_lengths: Optional[torch.Tensor] = None, pad_id: int = 1
) -> torch.Tensor:
    """Per-frame argmax; frames beyond the valid length become ``pad_id``.

    log_probs: (B, T, V) → (B, T) int32 token ids.
    """
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)
    if frame_lengths is not None:
        t = log_probs.shape[1]
        mask = torch.arange(t, device=ids.device)[None, :] < frame_lengths[:, None]
        ids = torch.where(mask, ids, pad_id)
    return ids


def collapse_repeats(
    ids: torch.Tensor, blank_id: int, pad_id: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CTC collapse: drop repeats then blanks, left-pack the rest.

    ids: (B, T) → (packed (B, T) padded with pad_id, lengths (B,)).
    """
    b, t = ids.shape
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype, device=ids.device), ids[:, :-1]], dim=1)
    keep = (ids != prev) & (ids != blank_id) & (ids != pad_id)
    pos = torch.arange(t, device=ids.device)[None, :]
    order_key = torch.where(keep, pos, t + pos)
    perm = torch.argsort(order_key, dim=1)
    packed = torch.gather(torch.where(keep, ids, pad_id), 1, perm)
    return packed, keep.sum(dim=1)
