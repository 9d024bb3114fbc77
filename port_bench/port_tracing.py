"""What the span metrics take from the program under test, beside
`port_api.py`: the port's tracing switch and counters
(`behindthescenes_tpu_torch.tracing`). A program without them, as the
port was before it had spans, gives None here and nothing to read.
"""
from __future__ import annotations


def _tracing():
    try:
        from behindthescenes_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def available() -> bool:
    return _tracing() is not None


def set_tracing(on: bool) -> None:
    """Turn the port's spans on or off."""
    _tracing().enable(on)


def counters() -> dict:
    """The port's counters: launches.<kernel>, h2d_copies, h2d_bytes."""
    return _tracing().counters()


def reset_counters() -> None:
    _tracing().reset()
