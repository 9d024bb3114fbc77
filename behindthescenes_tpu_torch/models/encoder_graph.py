"""CUDA graphs of the encode (`BTSNet.encode`): the inference encode's,
and the training encode's forward and backward passes.

Run eagerly, a ResNet-50 monodepth2 encode issues about 500 kernels from
Python (a conv in eval mode is about six: two casts, the conv, the bias,
a cast back and BatchNorm, most with an activation after), each a few
microseconds of device work behind tens of microseconds of host
dispatch; in training, with BatchNorm on batch statistics, about 1,900
forward and 2,300-2,500 in the backward pass. On the card the host's
issue, not the device, then sets how fast depth runs and how fast the
trainer steps. Both caches record the backbone's kernels once per input
signature in `torch.cuda.CUDAGraph`s and replay them with one launch: the
same cuDNN convolutions, casts and BatchNorm kernels at the same
addresses.

`EncoderGraphs`, the inference encode (no gradient, BatchNorm on its
running statistics, no flip):

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

`TrainEncoderGraphs`, the training encode's backbone (`takes_train_graph`:
on the card, gradient on, BatchNorm on batch statistics, a parameter
needing a gradient), a pair of graphs per input signature joined by an
autograd Function (`_Replay`):

- What is captured: the encoder over the (already gathered and flipped)
  images, with BatchNorm in train mode, to its latents. The flip of the
  input and of the latents, the resize to the first scale and the cast
  to the compute dtype stay eager around it, so one pair serves a
  flipped and an unflipped micro-step alike.
- The key (`train_graph_key`): `graph_key`, train mode and which
  parameters require a gradient.
- The forward graph runs the encoder with BatchNorm in train mode, its
  running statistics and counts moved in place by every replay; the
  backward graph takes the latents' gradients from static buffers into
  static parameter gradients, which the Function hands to autograd as
  fresh copies (`p.grad` never aliases a buffer the next replay
  overwrites), so `p.grad`, the accumulation and Adam see what the eager
  backward pass gives them. The warm-up and capture calls run the
  forward pass eagerly; every buffer of the encoder is put back as it was
  before them, so N micro-steps move the running statistics N times.
- The pairs share one private pool, so a replay of any of them may
  overwrite another's latents and the activations its backward pass
  reads: a call runs eagerly while the latents of any replay are still
  held outside the cache or a replay's backward pass has not run yet
  ("held"), and where BatchNorm sums its statistics over a process group
  ("group": its all-reduces are not captured).
- At most `GRAPHS_KEPT` pairs a net, the oldest dropped.

Counters (`tracing.count`): "encoder_graph.captures",
"encoder_graph.replays", and "encoder_graph.eager" (inference calls that
fell back because the last outputs were still held);
"encoder_graph.train_captures", "encoder_graph.train_replays" (one a
training encode that took its pair), "encoder_graph.train_eager" (one a
training encode that fell back), with the reason in
"encoder_graph.train_eager.group" or "encoder_graph.train_eager.held".
"""
from __future__ import annotations

import collections
import weakref
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.models.encoder import BatchNorm2d

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


def takes_train_graph(device: torch.device, train: bool,
                      images_need_grad: bool, module: nn.Module) -> bool:
    """Whether a training encode's backbone is one for
    `TrainEncoderGraphs`: on the card, gradient on, BatchNorm on batch
    statistics, the images needing no gradient (the graph's input is a
    static copy of them) and some parameter of `module` needing one."""
    return (train and device.type == "cuda" and torch.is_grad_enabled()
            and not images_need_grad
            and any(p.requires_grad for p in module.parameters()))


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


def train_graph_key(shape: Sequence[int], dtype, device, compute_dtype,
                    module: nn.Module, train: bool) -> tuple:
    """What a training pair of `module` was captured for: `graph_key`,
    train mode, and which parameters need a gradient."""
    return graph_key(shape, dtype, device, compute_dtype, module) + (
        train, tuple(p.requires_grad for p in module.parameters()))


def snapshot_buffers(module: nn.Module) -> list:
    """(buffer, copy) for every buffer of `module`: BatchNorm's running
    statistics and counts."""
    return [(b, b.clone()) for b in module.buffers()]


@torch.no_grad()
def restore_buffers(saved: list) -> None:
    """Put back, in place, the buffers `snapshot_buffers` copied."""
    for buf, copy in saved:
        buf.copy_(copy)


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


def reach(outputs: Sequence[torch.Tensor],
          params: Sequence[torch.Tensor]) -> Tuple[frozenset, ...]:
    """For each of `params`, the indices of the `outputs` whose autograd
    graph reaches it: where a backward pass brings no gradient for some
    outputs, a parameter that only they reach gets None, as eagerly."""
    where = {id(p): j for j, p in enumerate(params)}
    found = [set() for _ in params]
    for i, out in enumerate(outputs):
        seen, todo = set(), [out.grad_fn]
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            j = where.get(id(getattr(fn, "variable", None)))
            if j is not None:
                found[j].add(i)
            todo += [nxt for nxt, _ in fn.next_functions]
    return tuple(frozenset(f) for f in found)


class _TrainGraph(NamedTuple):
    forward: torch.cuda.CUDAGraph
    backward: Optional[torch.cuda.CUDAGraph]   # None: no feature needs grad
    images: torch.Tensor                       # the static input
    outputs: Tuple[torch.Tensor, ...]          # the static latents
    grad_outputs: Tuple[Optional[torch.Tensor], ...]  # their gradients
    params: Tuple[torch.Tensor, ...]           # those that need a gradient
    grads: Tuple[Optional[torch.Tensor], ...]  # theirs (None: unused)
    reach: Optional[Tuple[frozenset, ...]]     # `reach`; None: one latent
    baseline: Tuple[int, ...]                  # the latents' storage counts


class _Pending:
    """A replay whose backward pass is still to run (`done` once it has);
    its Function's context holds it, so it dies with the autograd graph."""
    __slots__ = ("done", "__weakref__")

    def __init__(self):
        self.done = False


class _Replay(torch.autograd.Function):
    """A training encode from its pair: the forward graph now, the
    backward graph when autograd reaches the latents. Inputs: the cache,
    the pair, then the pair's parameters (whose gradients it returns)."""

    @staticmethod
    def forward(ctx, cache, g, *params):
        ctx.set_materialize_grads(False)
        ctx.g = g
        ctx.pending = cache._begin()
        g.forward.replay()
        return tuple(o.detach() for o in g.outputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        g, pending = ctx.g, ctx.pending
        if pending.done:
            raise RuntimeError("the backward pass of a replayed training "
                               "encode runs once")
        pending.done = True
        got = {i for i, d in enumerate(grads) if d is not None}
        out = [None] * len(g.params)
        if got:
            for d, static in zip(grads, g.grad_outputs):
                if static is None:
                    continue
                if d is None:
                    static.zero_()
                else:
                    static.copy_(d)
            g.backward.replay()
            live = [j for j, s in enumerate(g.grads) if s is not None
                    and (g.reach is None or g.reach[j] & got)]
            # Fresh copies (x * 1 is exact, -0 and NaN too): autograd may
            # keep what it is given as p.grad, and the next replay
            # overwrites the static gradients.
            if live:
                copies = torch._foreach_mul([g.grads[j] for j in live], 1.0)
                for j, c in zip(live, copies):
                    out[j] = c
        return (None, None, *out)


class TrainEncoderGraphs:
    """The forward and backward graphs of one net's training encoder, by
    `train_graph_key` (module docstring)."""

    def __init__(self):
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._pending: Optional[weakref.ref] = None

    def latents(self, body: Callable[[torch.Tensor], Sequence[torch.Tensor]],
                images: torch.Tensor, compute_dtype,
                module: nn.Module) -> Optional[Tuple[torch.Tensor, ...]]:
        """body(images), the encoder `module` over the images (m, h, w, 3)
        on the card with BatchNorm in train mode, replayed from this input
        signature's pair, captured on its first call; the latents, whose
        gradient reaches the parameters through the backward graph, or
        None where the call has to run eagerly (BatchNorm over a process
        group, or an earlier replay still held)."""
        if any(isinstance(m, BatchNorm2d) and m.group is not None
               for m in module.modules()):
            return self._eager("group")
        if self._held():
            return self._eager("held")
        key = train_graph_key(images.shape, images.dtype, images.device,
                              compute_dtype, module, True)
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(body, images, module)
            self._graphs[key] = g
            if len(self._graphs) > GRAPHS_KEPT:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
            g.images.copy_(images)
        tracing.count("encoder_graph.train_replays")
        if g.backward is None:
            g.forward.replay()
            return tuple(o.detach() for o in g.outputs)
        return _Replay.apply(self, g, *g.params)

    @staticmethod
    def _eager(reason: str) -> None:
        tracing.count("encoder_graph.train_eager")
        tracing.count(f"encoder_graph.train_eager.{reason}")
        return None

    def _begin(self) -> _Pending:
        pending = _Pending()
        self._pending = weakref.ref(pending)
        return pending

    def _held(self) -> bool:
        """Whether a replay's backward pass is still to run, or any pair's
        latents are still held outside the cache."""
        pending = self._pending() if self._pending is not None else None
        if pending is not None and not pending.done:
            return True
        return not all(outputs_free(storage_counts(g.outputs), g.baseline)
                       for g in self._graphs.values())

    def _capture(self, body, images, module: nn.Module) -> _TrainGraph:
        dev = images.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        params = tuple(p for p in module.parameters() if p.requires_grad)
        static = images.clone(memory_format=torch.contiguous_format)
        saved = snapshot_buffers(module)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                outs = [o for o in body(static) if o.requires_grad]
                if outs:
                    torch.autograd.grad(outs, params,
                                        [torch.zeros_like(o) for o in outs],
                                        allow_unused=True)
                del outs
        torch.cuda.current_stream(dev).wait_stream(side)
        forward = torch.cuda.CUDAGraph()
        with torch.cuda.graph(forward, pool=self._pool):
            outputs = tuple(body(static))
        needs = [i for i, o in enumerate(outputs) if o.requires_grad]
        backward, grads, found = None, (), None
        grad_outputs = tuple(torch.empty_like(o) if o.requires_grad
                             else None for o in outputs)
        if needs:
            if len(needs) > 1:
                found = reach(outputs, params)
            backward = torch.cuda.CUDAGraph()
            with torch.cuda.graph(backward, pool=self._pool):
                grads = torch.autograd.grad(
                    [outputs[i] for i in needs], params,
                    [grad_outputs[i] for i in needs], allow_unused=True)
        outputs = tuple(o.detach() for o in outputs)
        restore_buffers(saved)
        tracing.count("encoder_graph.train_captures")
        return _TrainGraph(forward, backward, static, outputs, grad_outputs,
                           params, tuple(grads), found,
                           storage_counts(outputs))
