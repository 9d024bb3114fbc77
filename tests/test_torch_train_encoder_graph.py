"""The training encode's CUDA graphs (`models/encoder_graph.py`,
`TrainEncoderGraphs`) on the CPU: which calls take the pair of graphs,
what its key holds, BatchNorm's buffers put back after the warm-up, the
eager fallbacks and their counters, and the gradients the autograd
Function hands on. The capture itself runs on the card only
(`chip_smoke.py`'s training encoder graph phase); here a stand-in reruns
the backbone on each forward replay and its autograd backward on each
backward replay, and `BTSNet._features` is told it runs on the card, so
that the cache, the Function, the eager flips and casts around them and
the counters run as on the card.

The model is the KITTI-360 configuration's structure at a CPU's size:
ResNet-18 monodepth2, d_out 64, 32x96 images, two scales.
"""
import copy
from unittest import mock

import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.models import bts, encoder_graph
from behindthescenes_tpu_torch.models import encoder as encoder_lib
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.models.encoder_graph import (
    restore_buffers, snapshot_buffers, storage_counts, takes_train_graph,
    train_graph_key)

# One intra-op thread: pytest-xdist runs several workers on this CPU.
torch.set_num_threads(1)

H, W = 32, 96
MODEL_CONF = {
    "encoder": {"type": "monodepth2", "resnet_layers": 18,
                "num_ch_dec": [32, 32, 64, 128, 256], "d_out": 64,
                "scales": [0, 1]},
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 64},
    "mlp_fine": {"type": "empty"},
    "z_near": 3, "z_far": 80, "inv_z": True, "code_mode": "z",
    "learn_empty": False}
COUNTERS = ("encoder_graph.train_captures", "encoder_graph.train_replays",
            "encoder_graph.train_eager", "encoder_graph.train_eager.group",
            "encoder_graph.train_eager.held")


def _net(dtype=torch.float32):
    torch.manual_seed(0)
    net = BTSNet.from_conf(MODEL_CONF, dtype)
    for m in net.encoder.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return net


def _images(seed=0, n=1, v=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.uniform(-1, 1, (n, v, H, W, 3)).astype(np.float32))


def _counted():
    got = tracing.counters()
    return {c.split(".", 1)[1]: got.get(c, 0) for c in COUNTERS}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", ["train", "eval", "no_grad", "frozen",
                                  "images_grad"])
def test_which_training_calls_take_the_graph(device, case):
    """On the card, gradient on, train mode, the images needing no
    gradient and some parameter of the encoder needing one."""
    net = _net()
    if case == "frozen":
        net.encoder.requires_grad_(False)
    with torch.set_grad_enabled(case != "no_grad"):
        got = takes_train_graph(torch.device(device), case != "eval",
                                case == "images_grad", net.encoder)
    assert got == (device == "cuda" and case == "train")


def test_train_key_separates_flip_train_and_frozen_parameters():
    """Train mode and the parameters needing a gradient separate keys;
    the flip does not take part (it runs eagerly around the graph, so a
    flipped and an unflipped micro-step share their pair)."""
    net = _net()
    args = ((2, H, W, 3), torch.float32, torch.device("cpu"),
            torch.bfloat16, net.encoder)
    keys = {train: train_graph_key(*args, train) for train in (False, True)}
    assert keys[False] != keys[True]
    assert train_graph_key(*args, True) == keys[True]
    assert keys[True][:len(encoder_graph.graph_key(*args))] == \
        encoder_graph.graph_key(*args)
    net.encoder.encoder.encoder.conv1.weight.requires_grad_(False)
    assert train_graph_key(*args, True) != keys[True]


def test_buffers_put_back_exactly():
    """snapshot_buffers / restore_buffers around train-mode encodes leave
    every running statistic and num_batches_tracked as before, at the
    same addresses."""
    net = _net()
    bufs = dict(net.encoder.named_buffers())
    before = {k: v.clone() for k, v in bufs.items()}
    ptrs = {k: v.data_ptr() for k, v in bufs.items()}
    saved = snapshot_buffers(net.encoder)
    for seed in range(2):
        net._features(_images(seed), False, True)
    moved = [k for k, v in bufs.items() if not torch.equal(v, before[k])]
    assert any(k.endswith("num_batches_tracked") for k in moved)
    assert any(k.endswith("running_var") for k in moved)
    restore_buffers(saved)
    for k, v in net.encoder.named_buffers():
        assert torch.equal(v, before[k]) and v.data_ptr() == ptrs[k]
        assert v.dtype == before[k].dtype


class _Pass:
    """A stand-in graph: replay() runs fn."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _stand_in_capture(self, body, images, module):
    """TrainEncoderGraphs._capture on the CPU: the warm-up encodes with
    their backward passes and the buffers put back, as on the card; a
    forward replay reruns body into the static latents, a backward
    replay runs autograd over the last rerun into the static
    gradients."""
    params = tuple(p for p in module.parameters() if p.requires_grad)
    views = images.clone(memory_format=torch.contiguous_format)
    saved = snapshot_buffers(module)
    for _ in range(encoder_graph.WARMUP_CALLS):
        first = tuple(body(views))
    needs = all(o.requires_grad for o in first)
    used = torch.autograd.grad(first, params,
                               [torch.zeros_like(o) for o in first],
                               allow_unused=True) if needs else ()
    found = encoder_graph.reach(first, params) if len(first) > 1 else None
    outputs = tuple(torch.empty_like(o).detach() for o in first)
    grad_outputs = tuple(torch.empty_like(o) for o in outputs)
    grads = tuple(None if u is None else torch.empty_like(u) for u in used)
    last = {}

    def forward():
        with torch.enable_grad():
            last["out"] = tuple(body(views))
        for o, new in zip(outputs, last["out"]):
            o.copy_(new)

    def backward():
        got = torch.autograd.grad(last.pop("out"), params, grad_outputs,
                                  allow_unused=True)
        for static, g in zip(grads, got):
            if static is not None:
                static.copy_(g)

    restore_buffers(saved)
    tracing.count("encoder_graph.train_captures")
    return encoder_graph._TrainGraph(
        _Pass(forward), _Pass(backward) if needs else None, views, outputs,
        grad_outputs, params, grads, found, storage_counts(outputs))


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(encoder_graph.TrainEncoderGraphs, "_capture",
                        _stand_in_capture)
    tracing.reset(COUNTERS)


def _loss(feats, both):
    """A loss of the first feature map, or of both."""
    out = feats[0].float().square().mean() + feats[0].float().sum() * 1e-3
    if both:
        out = out + (feats[1].float() * 0.5).sum() * 1e-3
    return out


def _on_card(device, *args):
    return takes_train_graph(torch.device("cuda"), *args)


class _Run:
    """Micro-steps of one net through `BTSNet._features` with the cache
    (graph=True) or eagerly, each encode then its loss's backward pass;
    keeps every step's features and gradients."""

    def __init__(self, net, graph: bool, index=(1, 0)):
        self.net, self.graph = net, graph
        self.cache = net.train_encoder_graphs
        self.takes = _on_card if graph else (lambda *args: False)
        self.index = torch.tensor(index)
        self.feats, self.grads = [], []

    def encode(self, images, flip=False):
        with mock.patch.object(bts, "takes_train_graph", self.takes):
            return self.net._features(images[:, self.index], flip, True)

    def step(self, seed, flip=False, both=False):
        self.net.zero_grad(set_to_none=True)
        feats = self.encode(_images(seed), flip)
        assert feats is not None
        _loss(feats, both).backward()
        self.feats.append(tuple(f.detach().clone() for f in feats))
        self.grads.append({n: None if p.grad is None else p.grad.clone()
                           for n, p in self.net.encoder.named_parameters()})


def _same_runs(a: _Run, b: _Run):
    for fa, fb in zip(a.feats, b.feats, strict=True):
        assert all(torch.equal(x, y) for x, y in zip(fa, fb, strict=True))
    for ga, gb in zip(a.grads, b.grads, strict=True):
        for name, g in ga.items():
            if g is None:
                assert gb[name] is None, name
            else:
                assert torch.equal(g, gb[name]), name
    for (n, x), y in zip(a.net.encoder.named_buffers(),
                         b.net.encoder.buffers(), strict=True):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("both", [False, True], ids=["one_map", "two_maps"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_replays_equal_the_eager_steps(stand_in, dtype, both):
    """Micro-steps, unflipped and flipped, from the cache equal the eager
    ones bit for bit: features, every gradient (None where eager has
    None: with one map used, the second map's own convolution), and
    every running statistic and count after them; one capture serves
    both flips."""
    graph, eager = _Run(_net(dtype), True), _Run(_net(dtype), False)
    flips = (False, True, False, True)
    for seed, flip in enumerate(flips):
        for run in (graph, eager):
            run.step(seed, flip, both)
    _same_runs(graph, eager)
    if not both:
        unused = [n for n, g in eager.grads[0].items() if g is None]
        assert unused and all(".decoder." in f".{n}" for n in unused)
    assert _counted() == {"train_captures": 1, "train_replays": 4,
                          "train_eager": 0, "train_eager.group": 0,
                          "train_eager.held": 0}


def test_frozen_backbone_replays_the_forward_pass_alone(stand_in):
    """monodepth2's `freeze`: the features need no gradient, so the pair
    is a forward graph alone; its replays equal the eager encodes, the
    running statistics move alike, and no encoder parameter gets a
    gradient."""
    runs = []
    for graph in (True, False):
        net = _net()
        net.encoder.freeze = True
        runs.append(_Run(net, graph))
        for seed, flip in enumerate((False, True, False)):
            runs[-1].encode(_images(seed), flip)
            feats = runs[-1].encode(_images(seed + 3), flip)
            runs[-1].feats.append(tuple(f.clone() for f in feats))
            runs[-1].grads.append({n: p.grad for n, p in
                                   net.encoder.named_parameters()})
            del feats
    _same_runs(*runs)
    assert all(g is None for g in runs[0].grads[-1].values())
    (g,) = runs[0].cache._graphs.values()
    assert g.backward is None
    assert _counted() == {"train_captures": 1, "train_replays": 6,
                          "train_eager": 0, "train_eager.group": 0,
                          "train_eager.held": 0}


def test_no_gradient_aliases_a_static_buffer(stand_in):
    """Each p.grad is a tensor of its own, which the next replay leaves
    as it was."""
    run = _Run(_net(), True)
    run.step(0)
    held = {n: p.grad for n, p in run.net.encoder.named_parameters()
            if p.grad is not None}
    (g,) = run.cache._graphs.values()
    static = {s.untyped_storage().data_ptr() for s in g.grads
              if s is not None}
    assert held and not static & {t.untyped_storage().data_ptr()
                                  for t in held.values()}
    kept = {n: t.clone() for n, t in held.items()}
    run.net.zero_grad(set_to_none=True)
    run.step(1)
    assert all(torch.equal(held[n], kept[n]) for n in held)


@pytest.mark.parametrize("case", ["group", "held_features",
                                  "pending_backward", "dropped_backward",
                                  "backward_twice", "evict"])
def test_fallbacks_and_counters(stand_in, monkeypatch, case):
    """The eager fallbacks: BatchNorm over a process group; latents of a
    replay still held (f32: the first scale's features are a view of
    them); a replay whose backward pass is still to run (its autograd
    graph alive); and at most GRAPHS_KEPT pairs, the least recently used
    dropped. Each counts as specified; a fallback's features are the
    eager encode's."""
    run = _Run(_net(), True)
    want = {"train_captures": 1, "train_replays": 1, "train_eager": 0,
            "train_eager.group": 0, "train_eager.held": 0}
    if case == "group":
        # One process: the group's sum is this rank's own.
        monkeypatch.setattr(encoder_lib, "all_reduce_sum",
                            lambda x, group: x)
        for m in run.net.encoder.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.group = "ranks"
        eager = _Run(copy.deepcopy(run.net), False)
        for seed, flip in ((0, False), (1, True)):
            got, ref = run.encode(_images(seed), flip), \
                eager.encode(_images(seed), flip)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
        want.update(train_captures=0, train_replays=0, train_eager=2)
        want["train_eager.group"] = 2
    elif case == "held_features":
        feats = run.encode(_images(0))
        _loss(feats, False).backward()
        kept = feats[0][0, :1]
        del feats
        assert run.encode(_images(1))[0].grad_fn is not None
        del kept
        run.step(2)
        want.update(train_replays=2, train_eager=1)
        want["train_eager.held"] = 1
    elif case == "pending_backward":
        # A sum keeps no feature for its backward pass: the features are
        # free, and the pending backward pass alone holds the pair.
        feats = run.encode(_images(0))
        loss = feats[0].sum() + feats[1].sum()
        del feats
        run.encode(_images(1))
        loss.backward()
        run.step(2)
        want.update(train_replays=2, train_eager=1)
        want["train_eager.held"] = 1
    elif case == "dropped_backward":
        loss = _loss(run.encode(_images(0)), False)
        del loss
        run.step(1)
        want.update(train_replays=2)
    elif case == "backward_twice":
        loss = _loss(run.encode(_images(0)), False)
        loss.backward(retain_graph=True)
        with pytest.raises(RuntimeError, match="runs once"):
            loss.backward()
    else:
        widths = [W - 16 * k for k in range(encoder_graph.GRAPHS_KEPT)]
        more = W - 16 * len(widths)
        for w in widths + [widths[0], more, widths[0], widths[1]]:
            feats = run.encode(_images(0)[..., :w, :])
            _loss(feats, False).backward()
            del feats
        assert len(run.cache._graphs) == encoder_graph.GRAPHS_KEPT
        want.update(train_captures=len(widths) + 2,
                    train_replays=len(widths) + 4)
    assert _counted() == want


def test_training_encode_on_the_cpu_counts_nothing():
    """BTSNet.encode with train=True on the CPU runs eagerly and leaves
    every training graph counter at 0."""
    net = _net()
    ref = copy.deepcopy(net)
    tracing.reset(COUNTERS)
    images = _images(4)
    projs = torch.tensor([[0.78, 0, 0], [0, 2.9, 0.27], [0, 0, 1]]
                         ).expand(1, 2, 3, 3)
    poses = torch.eye(4).expand(1, 2, 4, 4)
    got = net.encode(images, projs, poses, ids_encoder=[1, 0], do_flip=True,
                     train=True).features
    want = ref._features(images[:, torch.tensor([1, 0])], True, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert all(v == 0 for v in _counted().values())
