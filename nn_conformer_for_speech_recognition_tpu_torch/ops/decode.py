"""CTC decoding, port of
`nn_conformer_for_speech_recognition_tpu/ops/decode.py`: ``greedy_decode``,
``collapse_repeats``, the fixed-width CTC prefix beam search
(``BeamState``, ``_beam_step_core``, ``ctc_beam_search``) and its
vocabulary-sharded variant (``ctc_beam_search_sharded``).

The beam search keeps the JAX package's formulation (Hannun et al. 2014 on
dense arrays): a beam of ``beam`` hypotheses per utterance, per frame only
the top-``prune`` non-blank tokens extend them, and since distinct beams
hold distinct prefixes the only duplicate is an *extend* that lands on an
existing *stay*, found by a (beam, beam, prune) match of rolling hashes.
Here the batch is a dimension written out (the ``vmap``), the frames are a
host loop (the ``scan``), and the picks are gathers (the one-hot
contractions there are a TPU workaround and give the same values).  There
is no TPU kernel behind it, so these are torch ops on either device: some
sixty small launches a frame, which makes the search host-bound on a GPU.

What decides hypotheses and is therefore kept exactly: ties in every
selection go to the lower index (stable descending sorts: most candidates
tie at −1e30, and which dummy beam survives decides later merges); the
prefix hash is 32-bit with wrap-around (held in int64, masked); everything
is float32; −1e30 stands in for −inf.

`ctc_beam_search_sharded` decodes log-probs split over the vocabulary
across a model group (`parallel.mesh.Axis`), one frame's V-dependent
pieces exchanged by collectives, and gives every rank the hypotheses of
`ctc_beam_search` on the whole log-probs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import Axis, all_gather

NEG_INF = -1e30
_HASH_MULT = 1000003
_HASH_INIT_MULT = 2654435761
_HASH_MASK = 0xFFFFFFFF


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


class BeamState(NamedTuple):
    prefixes: torch.Tensor  # (B, beam, Lmax) int32, -1 padded
    lengths: torch.Tensor  # (B, beam) int32
    last: torch.Tensor  # (B, beam) int32, -1 for the empty prefix
    p_b: torch.Tensor  # (B, beam) log prob of the prefix ending in blank
    p_nb: torch.Tensor  # (B, beam) log prob of the prefix ending in non-blank
    phash: torch.Tensor  # (B, beam) int64 holding the uint32 rolling hash


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, best first, ties to
    the lower index (``torch.topk`` promises no order among ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def _beam_step_core(
    state: BeamState,
    tok_lp: torch.Tensor,  # (B, P) the frame's pruned non-blank candidates
    tok_ids: torch.Tensor,  # (B, P) int64
    lp_blank: torch.Tensor,  # (B,)
    lp_last: torch.Tensor,  # (B, beam) log-prob of each beam's last token, NEG_INF for empty prefixes
    active: torch.Tensor,  # (B,) bool: the frame lies within the row's length
    *,
    beam: int,
    prune: int,
) -> BeamState:
    """One prefix-beam update for every row of the batch."""
    bsz, lmax = state.prefixes.shape[0], state.prefixes.shape[2]
    neg = torch.full((), NEG_INF, dtype=state.p_b.dtype, device=state.p_b.device)

    # "stay" candidates, one per beam: a blank, or a repeat of the last token
    both = torch.logaddexp(state.p_b, state.p_nb)
    stay_pb = both + lp_blank[:, None]
    stay_pnb = state.p_nb + lp_last
    # "extend" candidates, beam × prune: a repeated token extends only the
    # blank-ending mass, another token the whole mass
    same_as_last = tok_ids[:, None, :] == state.last[:, :, None]
    ext_pnb = torch.where(same_as_last, state.p_b[:, :, None], both[:, :, None]) + tok_lp[:, None, :]
    overflow = state.lengths >= lmax  # (B, beam): no room to extend
    ext_hash = (state.phash[:, :, None] * _HASH_MULT + (tok_ids[:, None, :] + 1)) & _HASH_MASK

    # merge: extend(j, tok) == stay(i), i.e. prefix_j + tok = prefix_i; only
    # p_nb mass moves (an extension carries no blank mass)
    match = (
        (state.phash[:, :, None, None] == ext_hash[:, None, :, :])
        & (state.lengths[:, :, None, None] == state.lengths[:, None, :, None] + 1)
        & ~overflow[:, None, :, None]
    )  # (B, beam_i, beam_j, P)
    ext_masked = torch.where(match, ext_pnb[:, None], neg)
    m = ext_masked.amax(dim=(2, 3))
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    absorbed = m_safe + torch.log(torch.exp(ext_masked - m_safe[:, :, None, None]).sum(dim=(2, 3)))
    absorbed = torch.where(dead, neg, absorbed)
    killed = match.any(dim=1) | overflow[:, :, None]  # (B, beam, P)
    merged_pb = torch.cat([stay_pb, neg.expand(bsz, beam * prune)], dim=1)
    merged_pnb = torch.cat(
        [torch.logaddexp(stay_pnb, absorbed), torch.where(killed, neg, ext_pnb).reshape(bsz, -1)], dim=1)

    # the best ``beam`` of the beam + beam·prune candidates
    top_idx = _top_indices(torch.logaddexp(merged_pb, merged_pnb), beam)  # (B, beam)
    is_ext = top_idx >= beam
    ext_idx = torch.clamp_min(top_idx - beam, 0)
    parent = torch.where(is_ext, ext_idx // prune, top_idx)
    sel_tok = torch.where(is_ext, tok_ids.gather(1, ext_idx % prune), -1).to(torch.int32)
    parent_len = state.lengths.gather(1, parent)
    prefixes = state.prefixes.gather(1, parent[:, :, None].expand(-1, -1, lmax))
    slot = torch.arange(lmax, device=prefixes.device)
    append = (slot == parent_len[:, :, None]) & is_ext[:, :, None]
    new = BeamState(
        prefixes=torch.where(append, sel_tok[:, :, None], prefixes),
        lengths=parent_len + is_ext.to(torch.int32),
        last=torch.where(is_ext, sel_tok, state.last.gather(1, parent)),
        p_b=merged_pb.gather(1, top_idx),
        p_nb=merged_pnb.gather(1, top_idx),
        phash=torch.where(is_ext, ext_hash.reshape(bsz, -1).gather(1, ext_idx), state.phash.gather(1, parent)),
    )
    # a frame at or beyond the row's length carries the whole state through
    return BeamState(*(torch.where(active.reshape(-1, *(1,) * (n.dim() - 1)), n, o) for n, o in zip(new, state)))


@torch.no_grad()
def ctc_beam_search(
    log_probs: torch.Tensor,
    frame_lengths: Optional[torch.Tensor] = None,
    *,
    blank_id: int = 0,
    beam: int = 8,
    prune: int = 8,
    max_label_len: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search.

    log_probs: (B, T, V) log-softmax outputs; frame_lengths: (B,) valid
    frame counts (default: all T).  Returns (tokens (B, beam,
    max_label_len) int32 padded with -1, lengths (B, beam) int32, scores
    (B, beam) float32), best first.  Runs on the device of ``log_probs``.
    """
    bsz, t, v = log_probs.shape
    dev = log_probs.device
    prune = min(prune, v - 1)
    lp = log_probs.to(torch.float32)
    if frame_lengths is None:
        frame_lengths = torch.full((bsz,), t, dtype=torch.int32, device=dev)
    frame_lengths = frame_lengths.to(dev)

    # the V-wide selection for all frames at once, before the loop
    lp_noblank = lp.clone()
    lp_noblank[:, :, blank_id] = NEG_INF
    tok_ids = _top_indices(lp_noblank, prune)  # (B, T, P)
    tok_lp = lp_noblank.gather(2, tok_ids)
    lp_blank = lp[:, :, blank_id]

    def last_lp(state: BeamState, frame: int) -> torch.Tensor:
        return lp[:, frame].gather(1, torch.clamp_min(state.last, 0).to(torch.int64))

    return _search(tok_lp, tok_ids, lp_blank, last_lp, frame_lengths, t, beam=beam, prune=prune,
                   max_label_len=max_label_len)


def _search(tok_lp, tok_ids, lp_blank, last_lp, frame_lengths, t: int, *, beam: int, prune: int,
            max_label_len: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frame loop of both searches, from the (B, T, P) candidates, the
    (B, T) blank log-probs and ``last_lp(state, frame)``, the (B, beam)
    log-prob of each beam's last token (any value where it has none)."""
    bsz, dev = tok_lp.shape[0], tok_lp.device
    first = torch.arange(beam, device=dev) == 0
    state = BeamState(
        prefixes=torch.full((bsz, beam, max_label_len), -1, dtype=torch.int32, device=dev),
        lengths=torch.zeros((bsz, beam), dtype=torch.int32, device=dev),
        last=torch.full((bsz, beam), -1, dtype=torch.int32, device=dev),
        p_b=torch.where(first, 0.0, NEG_INF).to(torch.float32).expand(bsz, beam).contiguous(),
        p_nb=torch.full((bsz, beam), NEG_INF, dtype=torch.float32, device=dev),
        # distinct initial hashes, so that the empty dummy beams do not
        # merge with the real empty prefix
        phash=((torch.arange(beam, device=dev) * _HASH_INIT_MULT) & _HASH_MASK).expand(bsz, beam).contiguous(),
    )
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    # frames at or beyond the longest row change nothing: stop there
    for frame in range(min(t, int(frame_lengths.max())) if bsz else 0):
        has_last = state.last >= 0
        lp_last = last_lp(state, frame)
        state = _beam_step_core(
            state, tok_lp[:, frame], tok_ids[:, frame], lp_blank[:, frame], torch.where(has_last, lp_last, neg),
            frame < frame_lengths, beam=beam, prune=prune,
        )
    score = torch.logaddexp(state.p_b, state.p_nb)
    order = torch.sort(-score, dim=1, stable=True)[1]
    return (
        state.prefixes.gather(1, order[:, :, None].expand(-1, -1, max_label_len)),
        state.lengths.gather(1, order),
        score.gather(1, order),
    )


@torch.no_grad()
def ctc_beam_search_sharded(
    lp_local: torch.Tensor,
    frame_lengths: Optional[torch.Tensor] = None,
    *,
    axis: Axis,
    blank_id: int = 0,
    beam: int = 8,
    prune: int = 8,
    max_label_len: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vocabulary-sharded CTC prefix beam search over the model group
    ``axis`` (every rank of it calls this).  Each rank holds ``lp_local``,
    its (B, T, V/mp) slice of the log-probs (rank r: vocabulary entries
    r·V/mp onwards), so the whole log-probs never sit on one card.  As the
    JAX function under ``shard_map``:

    * per-frame candidates: local top-``prune``, ``all_gather``, global
      top-``prune`` (exact: the global top-P lies in the union of the
      local ones; ties go to the lower rank, then the lower index, so to
      the lower token id, as in `ctc_beam_search`);
    * the blank log-prob: a masked all-reduce (one rank owns blank);
    * the repeat-of-last lookup, frame by frame: a one-hot selection over
      the local slice and an all-reduce, in exact float32 (one nonzero
      term: no tensor-core product, whose TF32 inputs would round it).

    The V-independent bookkeeping (`_beam_step_core`) runs alike on every
    rank, so every rank returns the same (tokens, lengths, scores), those
    of `ctc_beam_search` on the whole log-probs."""
    bsz, t, v_local = lp_local.shape
    dev = lp_local.device
    mp = axis.size
    lp = lp_local.to(torch.float32)
    if frame_lengths is None:
        frame_lengths = torch.full((bsz,), t, dtype=torch.int32, device=dev)
    frame_lengths = frame_lengths.to(dev)
    local_ids = axis.rank * v_local + torch.arange(v_local, device=dev)
    is_blank = local_ids == blank_id

    # per-frame candidates for all frames at once: local top-P, gathered, global top-P
    lp_noblank = torch.where(is_blank, NEG_INF, lp)
    p_local = min(prune, v_local)
    loc_idx = _top_indices(lp_noblank, p_local)
    loc_lp = lp_noblank.gather(2, loc_idx)
    all_lp = all_gather(loc_lp, axis, dim=2)  # (B, T, mp·Pl), rank by rank
    all_ids = all_gather(loc_idx + axis.rank * v_local, axis, dim=2)
    prune = min(prune, mp * p_local, mp * v_local - 1)
    sel = _top_indices(all_lp, prune)
    tok_lp, tok_ids = all_lp.gather(2, sel), all_ids.gather(2, sel)
    # the blank log-prob: exactly one rank owns it, the others add zeros
    lp_blank = torch.where(is_blank, lp, 0.0).sum(dim=2)
    if axis.spread:
        dist.all_reduce(lp_blank, group=axis.group)

    def last_lp(state: BeamState, frame: int) -> torch.Tensor:
        onehot = state.last[:, :, None] == local_ids  # (B, beam, Vl)
        picked = torch.where(onehot, lp[:, frame, None, :], 0.0).sum(dim=2)
        if axis.spread:
            dist.all_reduce(picked, group=axis.group)
        return picked

    return _search(tok_lp, tok_ids, lp_blank, last_lp, frame_lengths, t, beam=beam, prune=prune,
                   max_label_len=max_label_len)
