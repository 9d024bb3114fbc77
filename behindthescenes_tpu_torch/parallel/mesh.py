"""Ranks, process groups and sharding helpers (counterpart of
behindthescenes_tpu/parallel/mesh.py).

The JAX package runs data parallel training and ray-sharded evaluation on
a device mesh, and its multi-host path gives each host its own loader
batch (a disjoint dataset shard) that joins the others into one global
batch. The port keeps those semantics with one process per rank and a
`torch.distributed` process group:

- training: `batch_size` counts items per rank, the global batch is the
  concatenation of every rank's batch, parameters are the same on every
  rank, and the step computes the function of the 1-rank step on the
  global batch (BatchNorm and the loss reduce their sums over the group,
  the gradient is all-reduced once per micro-step);
- evaluation: every rank holds the whole frame, renders its share of the
  frame's rays (or of the occupancy grid's points) and receives the
  others', so every rank ends with the same outputs.

Gathers are all-reduces into a zeroed buffer in which each rank writes
its own rows: adding zeros is exact, and gloo carries all-reduce for CUDA
tensors (two ranks on one card) as NCCL does. A group of one rank, or
None, runs every helper as the single-process code path.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist


def init_distributed(config: Optional[dict] = None,
                     backend: Optional[str] = None) -> tuple:
    """Join the process group a launcher describes and return (rank,
    world). torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) is read first; else the JAX package's config keys
    `coordinator_address` ("host:port"), `num_processes` and `process_id`
    (behindthescenes_tpu/platform.py:54-72), or `dist_init_method` (a
    torch.distributed URL, such as a `file://` rendezvous) in place of the
    address. A single process, or a group already joined, skips the
    rendezvous. backend: "nccl" or "gloo" (default: nccl where CUDA is
    available, else gloo); a backend that cannot start raises."""
    config = config or {}
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    init = config.get("dist_init_method") or (
        f"tcp://{config['coordinator_address']}"
        if config.get("coordinator_address") else None)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
    elif init and int(config.get("num_processes", 1)) > 1:
        dist.init_process_group(
            backend, init_method=init,
            world_size=int(config["num_processes"]),
            rank=int(config.get("process_id", 0)))
    else:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def backend_for(device) -> Optional[str]:
    """gloo where the ranks compute on the CPU (`device` "cpu"), else None
    (`init_distributed`'s default)."""
    return "gloo" if device is not None and \
        str(device).startswith("cpu") else None


def default_group():
    """The default process group where one of more than one rank is
    joined, else None."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def eval_group():
    """The evaluators' group: None on one rank or with BTS_EVAL_SHARD=0
    (single-rank evaluation), as the JAX package's `eval_mesh`."""
    if os.environ.get("BTS_EVAL_SHARD", "1").strip().lower() in (
            "0", "false", "no", "off"):
        return None
    return default_group()


def rank_world(group) -> tuple:
    """(rank in `group`, its size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def host_device(group) -> torch.device:
    """Where a collective of host values runs: the current card for NCCL,
    the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(batch: dict, group) -> dict:
    """This rank's rows of every leaf's leading dimension (a global batch
    cut into `world` equal parts, in rank order). A leaf whose leading
    dimension does not divide the world raises, as the JAX package's
    multi-host `shard_batch` does: replicating it would drop the other
    ranks' items."""
    rank, world = rank_world(group)
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = v
            continue
        n = v.shape[0] if getattr(v, "ndim", 0) >= 1 else None
        if n is None or n % world:
            raise ValueError(
                f"batch leaf {k!r} of shape {getattr(v, 'shape', v)} does "
                f"not divide into {world} ranks")
        out[k] = v[rank * (n // world):(rank + 1) * (n // world)]
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable (the identity
    for None). Every rank must call it in the same order."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def global_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over every rank's elements (`x.mean()` of the
    global batch), differentiable."""
    _, world = rank_world(group)
    if world == 1:
        return x.mean()
    return all_reduce_sum(x.sum(), group) / (x.numel() * world)


def any_rank(flag: bool, group) -> bool:
    """Whether `flag` is set on any rank (every rank must call it)."""
    if group is None:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=host_device(group))
    dist.all_reduce(t, group=group)
    return bool(t.item() > 0)


def barrier(group) -> None:
    """Wait until every rank of the group reaches this point (an
    all-reduce, which NCCL and gloo both carry); a no-op for None."""
    any_rank(False, group)


def sum_host(values, group):
    """Element-wise sums over the ranks of a list of host floats, in
    float64 (every rank receives the same sums)."""
    if group is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64,
                     device=host_device(group))
    dist.all_reduce(t, group=group)
    return t.cpu().tolist()


def row_share(n: int, group) -> tuple:
    """This rank's rows (lo, hi) of n rows cut into `world` contiguous
    shares of s = ceil(n / world) rows, the last ones short; and s."""
    rank, world = rank_world(group)
    s = -(-n // world)
    lo = min(rank * s, n)
    return lo, min(lo + s, n), s


def shard_rows(x: torch.Tensor, dim: int, group, fill=None) -> torch.Tensor:
    """This rank's share of `x` along `dim` (`row_share`), padded to s rows
    with zeros, or with `fill(x, pad)` where given."""
    n = x.shape[dim]
    lo, hi, s = row_share(n, group)
    local = x.narrow(dim, lo, hi - lo)
    if hi - lo < s:
        pad = s - (hi - lo)
        tail = fill(x, pad) if fill is not None else x.new_zeros(
            x.shape[:dim] + (pad,) + x.shape[dim + 1:])
        local = torch.cat([local, tail], dim)
    return local


def gather_rows(local: torch.Tensor, n: int, dim: int,
                group) -> torch.Tensor:
    """Every rank's share (`shard_rows`) back into the n rows of the whole
    along `dim`, on every rank: each rank writes its rows into a zeroed
    buffer of world * s rows, and one all-reduce sums them. Exact: bool
    travels as uint8 and 16-bit floats as f32."""
    rank, world = rank_world(group)
    if world == 1:
        return local.narrow(dim, 0, n)
    s = local.shape[dim]
    dtype = local.dtype
    wire = {torch.bool: torch.uint8, torch.bfloat16: torch.float32,
            torch.float16: torch.float32}.get(dtype, dtype)
    buf = local.new_zeros(local.shape[:dim] + (world * s,)
                          + local.shape[dim + 1:], dtype=wire)
    buf.narrow(dim, rank * s, s).copy_(local)
    dist.all_reduce(buf, group=group)
    return buf.narrow(dim, 0, n).to(dtype)


def gather_tree(tree, n: int, dim: int, group):
    """`gather_rows` over the tensors of nested dicts."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, n, dim, group) for k, v in tree.items()}
    return gather_rows(tree, n, dim, group)


def sharded_point_query(group, query_batch_size: int,
                        body: Callable) -> Callable:
    """A dense point query `(pts (P, 3)) -> (P,)` that runs
    `body(chunk (1, Q, 3)) -> (Q,)` over chunks of at most
    `query_batch_size` points (counting points per rank), each rank over
    its share of the points (zero-padded, as the JAX package pads its
    chunks), gathered to every rank (behindthescenes_tpu/parallel/
    mesh.py:92-121). Shared by the LiDAR and 3D-box occupancy evaluators'
    density query."""
    def query(pts: torch.Tensor) -> torch.Tensor:
        local = shard_rows(pts, 0, group)
        out = [body(local[None, i:i + query_batch_size])
               for i in range(0, local.shape[0], query_batch_size)]
        return gather_rows(torch.cat(out), pts.shape[0], 0, group)
    return query
