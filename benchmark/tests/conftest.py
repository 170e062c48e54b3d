"""The benchmark's own tests: ``python -m pytest benchmark/tests -o addopts=""``
from the repo root.  On the CPU the card tests skip; on the card
``-m cuda`` runs them."""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")
