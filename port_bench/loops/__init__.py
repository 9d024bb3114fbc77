"""Loops that `harness.run` does not hold itself, one module a loop,
found by the "loop" of a traffic mix: `loops/<loop>.py`'s `run`."""
