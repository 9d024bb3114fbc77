"""The benchmark's CPU tests. Tests that need the card carry the marker
`card`; each decides inside the test whether a card is there and skips
on the CPU."""
import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where none is found")
