"""Spans and counters of the port.

A span is a named interval of the host's work. With tracing on
(`enable(True)`) it enters `torch.profiler.record_function(name)`, so an
active profiler records it as a `user_annotation` event on the same clock
as the kernels, copies and runtime calls issued inside it. With tracing
off (the default) it never reaches `record_function`, which costs about
14 us a call even with no profiler running. There is no store of spans
and no exporter: the profiler holds the events and writes them out.

The spans sit at the program's `mark` points. A caller's `mark(name)`
callback (stage timing with CUDA events) fires at the end of the span of
that name, so a stage's span and its mark are one boundary:

- `train_step` (BTSTrainer.train_step): encode, render, loss, backward,
  optimizer;
- `depth_frame` (DepthEvaluator.render, self-view path): encode, render;
- `data_wait` (training/harness.py): the wait for the loader's batch;
- the NVS and occupancy evaluators: encode, render (query,
  ground_truth), with no root.

Counters are plain integers, always on: the kernel wrappers count
"launches.<kernel>", and `to_device` counts "h2d_copies" and
"h2d_bytes".
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

_enabled = False
_counts: dict = {}

Mark = Optional[Callable[[str], None]]


def enable(on: bool = True) -> None:
    """Switch spans on or off (off by default)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


# ---------------------------------------------------------------- counters
def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counts)


def reset(names: Optional[Sequence[str]] = None) -> None:
    """Set `names` (default: every counter) back to 0."""
    if names is None:
        _counts.clear()
    else:
        for name in names:
            _counts.pop(name, None)


def to_device(data, device, dtype=None) -> torch.Tensor:
    """torch.as_tensor(data, dtype, device). Host data (a numpy array, a
    list, a Python scalar, or a tensor on another device) counts as one
    host-to-device copy in "h2d_copies" and its tensor's bytes in
    "h2d_bytes": on the card a copy from pageable memory, which the
    stream waits for."""
    out = torch.as_tensor(data, dtype=dtype, device=device)
    if not torch.is_tensor(data) or data.device != out.device:
        count("h2d_copies")
        count("h2d_bytes", out.numel() * out.element_size())
    return out


# ------------------------------------------------------------------- spans
class _Span:
    """A span that calls mark(name) at its end (where given) and, with
    tracing on, records the interval with the profiler."""
    __slots__ = ("name", "mark", "_record")

    def __init__(self, name: str, mark: Mark):
        self.name, self.mark, self._record = name, mark, None

    def __enter__(self):
        if _enabled:
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        if self.mark is not None and exc[0] is None:
            self.mark(self.name)
        return False


_NULL = contextlib.nullcontext()


def span(name: str, mark: Mark = None):
    """A context manager around one stage or request. Off and with no
    mark, the shared no-op context."""
    if not _enabled and mark is None:
        return _NULL
    return _Span(name, mark)


class _Stages:
    """The stage spans of one call, in order, tiling its root span (where
    it has one): stage k runs from stage k-1's mark, or the start, to its
    own. The code inside calls the context's value with each stage's name
    where it used to call mark(name)."""

    def __init__(self, root: Optional[str], names: Sequence[str],
                 mark: Mark):
        self.root = _Span(root, None) if root else None
        self.names, self.mark = tuple(names), mark
        self.next, self.open = 0, None

    def __enter__(self):
        if self.root is not None:
            self.root.__enter__()
        self._start()
        return self

    def _start(self):
        if self.next < len(self.names):
            self.open = _Span(self.names[self.next], self.mark).__enter__()
            self.next += 1

    def __call__(self, name: str) -> None:
        if self.open is None or name != self.open.name:
            raise ValueError(f"stage {name!r} out of order: expected "
                             f"{self.open.name if self.open else None!r}")
        done, self.open = self.open, None
        done.__exit__(None, None, None)
        self._start()

    def __exit__(self, *exc):
        if self.open is not None:
            # The body left before its last mark: close the stage without
            # calling mark.
            self.open.mark = None
            self.open.__exit__(*exc)
            self.open = None
        if self.root is not None:
            self.root.__exit__(*exc)
        return False


def stages(root: Optional[str], names: Sequence[str], mark: Mark = None):
    """A context whose value is the `mark` callback for the code inside:
    with tracing off, `mark` itself (None stays None); with tracing on, a
    callback that ends the current stage's span at each of `names` (and
    calls `mark` there) and starts the next, all inside a span `root`
    (where given)."""
    if not _enabled:
        return contextlib.nullcontext(mark)
    return _Stages(root, names, mark)
