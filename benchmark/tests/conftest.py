"""Tiny cells for the benchmark's CPU tests: the real cells' files with every
size cut so that a run takes seconds on the CPU."""

import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def tiny(cell: dict) -> dict:
    cell = copy.deepcopy(cell)
    cfg = cell["cfg"]
    cfg["vocab_size"] = 64
    cfg["model"]["encoder"].update(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64)
    cfg["model"]["subsampling"]["channels"] = [8, 4]
    cfg["model"]["decoder"].update(projection_dim=32, lstm_hidden=16)
    cell["traffic"] = dict(cell["traffic"], batch=4, clips=8, seconds=[1.0, 2.0])
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark import harness as H

    return lambda name: tiny(H.load_cell(name))
