"""CPU tests of the benchmark's harness (run: python -m pytest
gpubench/tests). Tests that need the card carry the `gpu` marker and skip
in the `card` fixture where there is none."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH))
sys.path.insert(0, BENCH)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_cell(name: str) -> dict:
    """The cell's files at a size a CPU test can hold (widths as
    published, fewer sites)."""
    import harness

    cell = harness.load_cell(name)
    t = cell["traffic"]
    if name == "pileup.s2":
        t.update(contig_bp=20_000, candidates=3_000)
    elif name == "haplotype.s5":
        t.update(contig_bp=20_000, sites_per_bucket=200)
    elif name == "pileup.train":
        t.update(rows=1_000)
        cell["config_data"]["train"]["batch_size"] = 50
    elif name == "haplotype.train":
        t.update(contig_bp=20_000, sites_per_bucket=120)
        cell["config_data"]["train"]["batch_size"] = 16
    return cell
