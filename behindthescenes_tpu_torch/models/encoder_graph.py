"""CUDA graphs of the inference encode (`BTSNet.encode`).

Run eagerly, a ResNet-50 monodepth2 encode issues about 500 kernels from
Python (a conv in eval mode is about six: two casts, the conv, the bias,
a cast back and BatchNorm, most with an activation after), each a few
microseconds of device work behind tens of microseconds of host
dispatch. On the card the host's issue, not the device, then sets how
fast single-image depth runs.
`EncoderGraphs` records the backbone's kernels once per input signature
in a `torch.cuda.CUDAGraph` and replays them with one launch: the same
cuDNN convolutions, casts and BatchNorm kernels at the same addresses.

- The key (`graph_key`): the gathered views' shape, dtype and device, the
  compute dtype, the address of every parameter and buffer of the encoder
  (new storage, as `load_state_dict(assign=True)` or `.to()` give, is
  captured anew; an in-place `copy_`, as `load_state_dict` does by
  default, is read by the next replay), the TF32 switches that pick the
  convolutions' and matmuls' precision, and inference mode (a graph's
  tensors made inside it cannot be written outside it).
- The graph's outputs are the per-scale features in the compute dtype,
  which the caller's grid holds; the f32 latents and every temporary stay
  in the graph's private pool. A replay overwrites the last replay's
  features, so it runs only where no tensor outside the cache still
  shares their storage (`outputs_free`); otherwise the call runs eagerly.
  Replays go on the current stream, behind the work that read the last
  features.
- At most `GRAPHS_KEPT` graphs a net, the oldest dropped.

Counters (`tracing.count`): "encoder_graph.captures",
"encoder_graph.replays", and "encoder_graph.eager" (calls that fell back
because the last outputs were still held).
"""
from __future__ import annotations

import collections
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from behindthescenes_tpu_torch import tracing

GRAPHS_KEPT = 4
# Eager calls on a side stream before a capture: cuDNN and the caching
# allocator settle, as torch.cuda.graphs' own warm-up does.
WARMUP_CALLS = 2


def takes_graph(device: torch.device, train: bool, do_flip: bool) -> bool:
    """Whether an encode replays a graph: on the card, with no gradient,
    BatchNorm on its running statistics and no flip; from nothing but
    what the call can observe."""
    return device.type == "cuda" and not (train or do_flip
                                          or torch.is_grad_enabled())


def _state_ptrs(module: nn.Module, out: list) -> list:
    """The address of every parameter and buffer of `module`, appended to
    `out`: a walk of the modules' own dicts, which every replay pays, in
    a quarter of the time of `parameters()` and `buffers()`."""
    for tensors in (module._parameters, module._buffers):
        out += [t.data_ptr() for t in tensors.values() if t is not None]
    for child in module._modules.values():
        _state_ptrs(child, out)
    return out


def graph_key(shape: Sequence[int], dtype, device, compute_dtype,
              module: nn.Module) -> tuple:
    """What a graph of `module` over views (shape, dtype, device) was
    captured for."""
    return (tuple(shape), dtype, device, compute_dtype,
            tuple(_state_ptrs(module, [])),
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
            torch.is_inference_mode_enabled())


def storage_counts(tensors: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    """The use count of each tensor's storage: every tensor (a view too)
    that shares it counts one."""
    return tuple(torch._C._storage_Use_Count(t.untyped_storage()._cdata)
                 for t in tensors)


def outputs_free(counts: Sequence[int], baseline: Sequence[int]) -> bool:
    """True where no storage of a graph's outputs is used by more tensors
    than right after the capture, when the cache alone held them."""
    return all(c <= b for c, b in zip(counts, baseline))


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    views: torch.Tensor                    # the static input
    outputs: Tuple[torch.Tensor, ...]      # the static features
    baseline: Tuple[int, ...]              # their storage counts alone


class EncoderGraphs:
    """The graphs of one net's inference encode, by `graph_key`."""

    def __init__(self):
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def features(self, body: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                            ...]],
                 images: torch.Tensor, index: torch.Tensor, compute_dtype,
                 module: nn.Module) -> Optional[Tuple[torch.Tensor, ...]]:
        """body(views) over the views `images[:, index]` (images (n, v, h,
        w, 3) on the card, index (nv,)), replayed from this input
        signature's graph, captured on its first call; views of the
        graph's outputs, or None where the last replay's are still held
        (the caller then runs body eagerly)."""
        shape = (images.shape[0], index.shape[0], *images.shape[2:])
        key = graph_key(shape, images.dtype, images.device, compute_dtype,
                        module)
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(body, images, index, shape)
            self._graphs[key] = g
            if len(self._graphs) > GRAPHS_KEPT:
                self._graphs.popitem(last=False)
        elif not outputs_free(storage_counts(g.outputs), g.baseline):
            tracing.count("encoder_graph.eager")
            return None
        else:
            self._graphs.move_to_end(key)
            torch.index_select(images, 1, index, out=g.views)
        g.graph.replay()
        tracing.count("encoder_graph.replays")
        return tuple(t.detach() for t in g.outputs)

    @staticmethod
    def _capture(body, images, index, shape) -> _Graph:
        views = torch.empty(shape, dtype=images.dtype, device=images.device)
        torch.index_select(images, 1, index, out=views)
        side = torch.cuda.Stream(images.device)
        side.wait_stream(torch.cuda.current_stream(images.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                body(views)
        torch.cuda.current_stream(images.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = tuple(body(views))
        tracing.count("encoder_graph.captures")
        return _Graph(graph, views, outputs, storage_counts(outputs))
