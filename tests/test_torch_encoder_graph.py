"""The inference encode's CUDA graphs (`models/encoder_graph.py`) on the
CPU: which calls take the graph, what its key holds, and the rule that
runs a call eagerly while the last replay's features are still held. The
graph itself, its capture and replay, runs on the card only
(`chip_smoke.py`'s encoder graph phase).

The model is the KITTI-360 configuration's structure at a CPU's size:
ResNet-18 monodepth2, d_out 64, 32x96 images.
"""
import copy

import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
from behindthescenes_tpu_torch.models import encoder_graph
from behindthescenes_tpu_torch.models.bts import BTSNet, _nearest_resize
from behindthescenes_tpu_torch.models.encoder_graph import (
    graph_key, outputs_free, storage_counts, takes_graph)

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
RENDERER = {"n_coarse": 8, "n_fine": 0, "n_fine_depth": 0, "depth_std": 1.0,
            "sched": [], "white_bkgd": False, "lindisp": True,
            "hard_alpha_cap": True}
COUNTERS = ("encoder_graph.captures", "encoder_graph.replays",
            "encoder_graph.eager")


def _net(dtype=torch.float32):
    torch.manual_seed(0)
    net = BTSNet.from_conf(MODEL_CONF, dtype)
    # BatchNorm's running statistics away from (0, 1), so that eval and
    # train mode differ.
    for m in net.encoder.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return net


def _inputs(seed=0, n=1, v=2):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.uniform(-1, 1, (n, v, H, W, 3)).astype(np.float32))
    projs = torch.tensor([[0.78, 0, 0], [0, 2.9, 0.27], [0, 0, 1]]
                         ).expand(n, v, 3, 3)
    poses = torch.eye(4).expand(n, v, 4, 4)
    return images, projs, poses


def _features_as_before(net, images, ids, do_flip, train):
    """The encode's CNN as it ran before the graph path existed."""
    n, _, h, w, _ = images.shape
    nv = len(ids)
    imgs = images[:, torch.as_tensor(ids)].reshape(n * nv, h, w, 3)
    if do_flip:
        imgs = imgs.flip(2)
    before = net.encoder.training
    net.encoder.train(train)
    latents = net.encoder(imgs.permute(0, 3, 1, 2))
    net.encoder.train(before)
    if do_flip:
        latents = [lat.flip(3) for lat in latents]
    h0, w0 = latents[0].shape[2:]
    c = net.encoder.latent_size
    return tuple(_nearest_resize(lat.permute(0, 2, 3, 1), h0, w0)
                 .reshape(n, nv, h0, w0, c).to(net.compute_dtype)
                 for lat in latents)


@pytest.mark.parametrize("case", ["no_grad", "grad", "train", "flip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_eager_calls_are_bit_equal_and_count_nothing(case, dtype):
    net = _net(dtype)
    ref = copy.deepcopy(net)
    images, projs, poses = _inputs(1)
    train, do_flip, grad = case == "train", case == "flip", case == "grad"
    for device in ("cpu", "cuda"):
        with torch.set_grad_enabled(grad):
            assert takes_graph(torch.device(device), train, do_flip) == (
                device == "cuda" and case == "no_grad")
    tracing.reset(COUNTERS)
    with torch.set_grad_enabled(grad):
        got = net.encode(images, projs, poses, ids_encoder=[1, 0],
                         do_flip=do_flip, train=train).features
        want = _features_as_before(ref, images, [1, 0], do_flip, train)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(g, w)
    assert all(tracing.counters().get(c, 0) == 0 for c in COUNTERS)
    if train:
        for a, b in zip(net.encoder.buffers(), ref.encoder.buffers()):
            assert torch.equal(a, b)


def _replace(net, how):
    enc = net.encoder
    state = {k: v.clone() for k, v in enc.state_dict().items()}
    if how == "assign":
        enc.load_state_dict(state, assign=True)
    elif how == "to":
        enc.to(torch.float64)
    elif how == "copy_":
        enc.load_state_dict(state)
    elif how == "tf32":
        torch.backends.cudnn.allow_tf32 = \
            not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("how,recaptures", [
    ("shape", True), ("compute_dtype", True), ("assign", True),
    ("to", True), ("tf32", True), ("copy_", False), ("nothing", False)])
def test_key_follows_shape_dtype_and_storage(how, recaptures):
    net = _net()
    shape = (1, 1, H, W, 3)
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        key = graph_key(shape, torch.float32, torch.device("cpu"),
                        torch.bfloat16, net.encoder)
        _replace(net, how)
        again = graph_key((1, 2, H, W, 3) if how == "shape" else shape,
                          torch.float32, torch.device("cpu"),
                          torch.float32 if how == "compute_dtype"
                          else torch.bfloat16, net.encoder)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert (key != again) == recaptures


def test_key_walks_every_parameter_and_buffer():
    net = _net()
    ptrs = graph_key((1,), torch.float32, torch.device("cpu"),
                     torch.float32, net.encoder)[4]
    want = [t.data_ptr() for t in (*net.encoder.parameters(),
                                   *net.encoder.buffers())]
    assert sorted(ptrs) == sorted(want)


@pytest.mark.parametrize("hold", ["nothing", "detach", "reshape", "slice",
                                  "grid"])
def test_held_outputs_force_the_eager_path(hold):
    outputs = (torch.zeros(1, 1, 4, 6, 8), torch.zeros(1, 1, 4, 6, 8))
    baseline = storage_counts(outputs)
    held = {"nothing": None,
            "detach": [t.detach() for t in outputs],
            "reshape": outputs[1].reshape(4, 48),
            "slice": outputs[0][0, 0, :2],
            "grid": tuple(t.detach() for t in outputs)}[hold]
    counts = storage_counts(outputs)
    assert outputs_free(counts, baseline) == (held is None)
    del held
    assert outputs_free(storage_counts(outputs), baseline)


@pytest.mark.parametrize("counts,free", [
    ((2, 2), True), ((2, 3), False), ((3, 2), False), ((1, 2), True)])
def test_outputs_free_compares_each_storage(counts, free):
    assert outputs_free(counts, (2, 2)) == free


def test_depth_frame_releases_its_features(monkeypatch):
    """DepthEvaluator.render keeps no tensor that shares its features'
    storage once it returns, so the next frame's encode can replay."""
    net = _net(torch.bfloat16)
    ev = DepthEvaluator(net, renderer_lib.RendererConfig.from_conf(RENDERER),
                        MODEL_CONF)
    seen = []
    encode = net.encode

    def keep(*args, **kwargs):
        grid = encode(*args, **kwargs)
        seen.append(grid.features)
        return grid

    monkeypatch.setattr(net, "encode", keep)
    images, projs, poses = _inputs(2, v=1)
    depth = ev.render(images, projs, poses)
    assert depth.shape == (1, H, W)
    alone = storage_counts([torch.zeros(1) for _ in seen[0]])
    assert storage_counts(seen[0]) == alone


class _StandIn:
    """A graph that reruns its body into the static outputs on replay."""

    def __init__(self, body, views, outputs):
        self.body, self.views, self.outputs = body, views, outputs

    def replay(self):
        for out, new in zip(self.outputs, self.body(self.views)):
            out.copy_(new)


def _stand_in_capture(body, images, index, shape):
    views = torch.empty(shape, dtype=images.dtype)
    torch.index_select(images, 1, index, out=views)
    outputs = tuple(torch.empty_like(o) for o in body(views))
    tracing.count("encoder_graph.captures")
    return encoder_graph._Graph(_StandIn(body, views, outputs), views,
                                outputs, storage_counts(outputs))


@pytest.mark.parametrize("case", ["replay", "held", "evict"])
def test_cache_replays_falls_back_and_drops_the_oldest(case, monkeypatch):
    """EncoderGraphs.features with the capture stood in for on the CPU:
    one capture per key, a replay per call, the eager fallback while the
    last features are held, and at most GRAPHS_KEPT graphs."""
    monkeypatch.setattr(encoder_graph.EncoderGraphs, "_capture",
                        staticmethod(_stand_in_capture))
    net = _net()
    graphs = encoder_graph.EncoderGraphs()
    index = torch.tensor([0])

    def body(views):
        return net._features(views, False, False)

    def call(seed, w=W):
        images = _inputs(seed)[0][..., :w, :]
        return images, graphs.features(body, images, index,
                                       torch.float32, net.encoder)

    tracing.reset(COUNTERS)
    with torch.no_grad():
        if case == "replay":
            for seed in range(3):
                images, got = call(seed)
                want = _features_as_before(net, images, [0], False, False)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
                del got
            want = {"captures": 1, "replays": 3, "eager": 0}
        elif case == "held":
            _, first = call(0)
            kept = tuple(f.clone() for f in first)
            assert call(1)[1] is None
            assert all(torch.equal(a, b) for a, b in zip(first, kept))
            del first
            assert call(2)[1] is not None
            want = {"captures": 1, "replays": 2, "eager": 1}
        else:
            widths = [W - 16 * k for k in range(encoder_graph.GRAPHS_KEPT)]
            # The first width used again, then one width more than the
            # cache keeps: the least recently used (the second) is
            # dropped, the first kept, the second captured anew.
            more = W - 16 * len(widths)
            for w in widths + [widths[0], more, widths[0], widths[1]]:
                call(0, w)
            assert len(graphs._graphs) == encoder_graph.GRAPHS_KEPT
            want = {"captures": len(widths) + 2,
                    "replays": len(widths) + 4, "eager": 0}
    got = tracing.counters()
    assert {c.split(".")[1]: got.get(c, 0) for c in COUNTERS} == want
