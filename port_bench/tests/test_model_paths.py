"""The paths a configuration can ask of the harness beyond the cells'
own: pixelNeRF's spatial encoder, a fine pass through its own MLP, and
colour predicted by the MLP (`sample_color` false), each taken from
override dicts alone; and the cells' yardsticks, pools and weights held
to what they were before those paths came in."""
import copy
import hashlib

import numpy as np
import pytest
import torch

from port_bench import calibrate, check, flops, harness, traffic
from port_bench import port_api as port
from port_bench.reference import model
from port_bench.reference.train import follow
from port_bench.tests import tiny
from port_bench.tests.test_reference import port_float64_steps
from port_bench.tests.test_work_counts import CountingPrecision
from port_bench.weights import make_weights

CPU = torch.device("cpu")
FINE = {"renderer": {"n_fine": 6, "n_fine_depth": 2},
        "model_conf": {"mlp_fine": {"type": "resnet", "n_blocks": 2,
                                    "d_hidden": 32}}}
COLOUR = {"renderer": {"n_fine": 6, "n_fine_depth": 2},
          "model_conf": {"sample_color": False,
                         "mlp_fine": {"type": "resnet", "n_blocks": 2,
                                      "d_hidden": 32}}}
SPATIAL = {"model_conf": {"encoder": {"type": "spatial",
                                      "resnet_layers": 34, "num_layers": 4,
                                      "pretrained": False}}}
MODELS = {"fine": FINE, "colour": COLOUR, "spatial": SPATIAL}
SPATIAL_DEPARTS = (
    "the port's SpatialEncoder departs from pixelNeRF's: it feeds the "
    "ResNet ImageNet-normalised [0, 1] images where pixelNeRF feeds the "
    "[-1, 1] images as they are, and repeats each map by nearest "
    "neighbour where pixelNeRF resizes bilinearly with align_corners=True")

# Each cell's pool and weights at tiny.cut's sizes, and the work counts
# at the cells' own sizes, as they were before the model paths.
DIGESTS = {
    "kitti360.train": (
        "8b9fc4499402a60ad7c4cf03530990f792f15527b6ce49512075f0cdf237a299",
        "6e39b0f3a9552885bb61c245ba17c4f1224466db757acf0e14959ef217ca3b79"),
    "kitti360.depth": (
        "ba736df58346eafc6c2a91363c217862fc1c9e2e02eadca11c24d504420eddcf",
        "6e39b0f3a9552885bb61c245ba17c4f1224466db757acf0e14959ef217ca3b79"),
    "re10k.train": (
        "b5c99e5625310b7894e5fe121346c578115153d4e84e2066f2803efe0244da56",
        "2988ef45b59d9554934d3a6c9171f45cbf38dbafc713ee2108b20c8ccfbbbb58"),
}


def cut(name, **extra):
    """kitti360.train's tiny cut with the model `name`'s overrides."""
    over, mix = tiny.cut("kitti360.train", **extra)
    over = copy.deepcopy(over)
    harness._merge(over, MODELS[name])
    return over, mix


def digest(items) -> str:
    h = hashlib.sha256()
    for name, t in items:
        h.update(name.encode())
        if torch.is_tensor(t):
            h.update(str(t.dtype).encode() + str(tuple(t.shape)).encode())
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        else:
            h.update(repr(t).encode())
    return h.hexdigest()


def test_work_counts_are_the_cells_own():
    k360, _ = calibrate.cell_conf("kitti360.train")
    re10k, _ = calibrate.cell_conf("re10k.train")
    depth, _ = calibrate.cell_conf("kitti360.depth")
    assert flops.train_step_flops(k360) == 710_170_116_096
    assert flops.train_step_flops(re10k) == 1_089_315_274_752
    assert flops.depth_frame_flops(depth) == 160_381_009_920


@pytest.fixture
def one_thread():
    """The CPU's pools round differently with the count of threads; the
    digests were taken on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("workload", sorted(DIGESTS))
def test_pools_and_weights_are_the_cells_own(workload, one_thread):
    over, mix_over = tiny.cut(workload)
    conf, mix = calibrate.cell_conf(workload, over, mix_over)
    weights = make_weights(conf["model_conf"], tiny.SEED, CPU)
    if mix["loop"] == "train":
        items = []
        for i, (b, d) in enumerate(traffic.train_pool(conf, mix, tiny.SEED,
                                                      CPU)):
            items += [(f"{i}.b.{k}", b[k]) for k in sorted(b)]
            items += [(f"{i}.d.{k}", d[k]) for k in d]
    else:
        frames = traffic.frame_pool(conf, mix, tiny.SEED, CPU)
        items = [(k, frames[k]) for k in sorted(frames)]
    specs = model.param_specs(conf["model_conf"])
    assert (digest(items), digest([(n, weights[n]) for n, _, _ in specs])) \
        == DIGESTS[workload]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_specs_are_the_programs_state(name):
    from behindthescenes_tpu_torch.models.bts import BTSNet
    over, _ = cut(name)
    conf, _ = calibrate.cell_conf("kitti360.train", over)
    state = BTSNet.from_conf(conf["model_conf"]).state_dict()
    specs = model.param_specs(conf["model_conf"])
    assert [(n, tuple(s)) for n, s, _ in specs] \
        == [(n, tuple(t.shape)) for n, t in state.items()]


@pytest.mark.parametrize("layers,maps", [(34, 4), (18, 2), (50, 5),
                                         (34, 1)])
def test_spatial_encoder_flops_match_counted_convolutions(layers, maps):
    conf, _ = calibrate.cell_conf("kitti360.train")
    mc = dict(conf["model_conf"], encoder={
        "type": "spatial", "resnet_layers": layers, "num_layers": maps})
    counter = CountingPrecision()
    with torch.no_grad():
        lat = model.encode(make_weights(mc, 1, "cpu"),
                           torch.zeros(1, 3, 64, 96), mc, False, counter)
    assert flops.encoder_flops(mc, 64, 96) == counter.flops
    assert lat.shape == (1, model.latent_size(mc), 32, 48)


def test_fine_pass_flops_are_its_samples_through_its_mlp():
    over, _ = cut("colour")
    conf, _ = calibrate.cell_conf("kitti360.train", over)
    coarse_only, _ = calibrate.cell_conf(
        "kitti360.train", dict(over, renderer={"n_fine": 0,
                                               "n_fine_depth": 0}))
    mc = conf["model_conf"]
    n, rays = conf["batch_size"], mc["ray_batch_size"]
    d_in = 64 + 3 * 13
    # lin_out gives density and colour.
    fine = 2 * (d_in * 32 + 32 * 4 + 2 * 2 * 32 * 32)
    assert flops.mlp_flops_per_sample(mc) == 2 * (d_in * 64 + 64 * 4)
    assert flops.mlp_flops_per_sample(mc, "mlp_fine") == fine
    assert flops.train_step_flops(conf) \
        - flops.train_step_flops(coarse_only) \
        == 3 * n * rays * (64 + 6) * fine


def test_fine_draws_follow_the_cells_draws():
    over, mix_over = cut("fine")
    conf, mix = calibrate.cell_conf("kitti360.train", over, mix_over)
    plain, _ = calibrate.cell_conf("kitti360.train", tiny.TRAIN)
    gens = []
    for _ in range(2):
        gens.append(torch.Generator())
        gens[-1].manual_seed(5)
    got = traffic.make_draws(conf, 2, 4, gens[0], CPU)
    base = traffic.make_draws(plain, 2, 4, gens[1], CPU)
    for k, v in base.items():
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v))
    rays = conf["model_conf"]["ray_batch_size"]
    assert got["fine_u"].shape == got["fine_jitter"].shape == (2, rays, 4)
    assert got["fine_normals"].shape == (2, rays, 2)
    assert 0 <= float(got["fine_u"].min()) and float(got["fine_u"].max()) < 1
    fd = port.port_draws(got).fine
    assert fd.u is got["fine_u"] and fd.normals is got["fine_normals"]
    assert port.port_draws(base).fine is None


@pytest.mark.parametrize("name", [
    "fine", "colour",
    pytest.param("spatial", marks=pytest.mark.xfail(
        strict=True, reason=SPATIAL_DEPARTS))])
def test_model_path_is_correct(name):
    over, mix = cut(name, bf16=False)
    result, _ = harness.run("kitti360.train", tiny.SEED, 0.5, False,
                            device="cpu", overrides=over, mix_overrides=mix)
    assert result["correct"] is True, result["check"]


@pytest.mark.parametrize("name", ["fine", "colour"])
def test_fine_steps_match_in_float64(name):
    """The port's trainer and the reference, both in float64, follow the
    same steps of a fine pass (the importance bins, the samples around
    the depth, whose gradient flows back through it, the fine MLP)."""
    over, mix_over = cut(name)
    conf, mix = calibrate.cell_conf("kitti360.train", over, mix_over)
    conf["seed"] = tiny.SEED
    pool = traffic.train_pool(conf, dict(mix, pool=2), tiny.SEED, CPU)
    got = port_float64_steps(conf, pool, tiny.SEED)
    ref = follow(conf, make_weights(conf["model_conf"], tiny.SEED, CPU),
                 pool, tiny.SEED, "float64")
    numbers = check.train_numbers(got, ref)
    assert numbers["loss_gap"] < 1e-6, numbers
    assert numbers["grad_median_gap"] < 1e-5, numbers
    assert numbers["change_gap"] < 1e-4, numbers


def test_spatial_departure_is_the_input_and_the_resize(monkeypatch):
    """The reference given the port's two departures (its input scaling
    and its nearest repeat-and-crop) holds the spatial run correct: the
    rest of the spatial path agrees."""
    def port_input(images):
        return ((images * 0.5 + 0.5) - 0.45) / 0.225

    def port_resize(f, size):
        th, tw = size
        return f.repeat_interleave(th // f.shape[2], 2) \
            .repeat_interleave(tw // f.shape[3], 3)[:, :, :th, :tw]
    monkeypatch.setattr(model, "spatial_input", port_input)
    monkeypatch.setattr(model, "spatial_resize", port_resize)
    over, mix = cut("spatial", bf16=False)
    result, _ = harness.run("kitti360.train", tiny.SEED, 0.5, False,
                            device="cpu", overrides=over, mix_overrides=mix)
    assert result["correct"] is True, result["check"]


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged",
                                   "fine_pass_dropped"])
def test_fault_on_the_fine_colour_path_is_not_correct(fault):
    over, mix = cut("colour", bf16=False)
    result, _ = harness.run("kitti360.train", tiny.SEED, 0.5, False,
                            device="cpu", overrides=over, mix_overrides=mix,
                            fault=fault)
    assert result["correct"] is False, result["check"]


def test_control_on_the_fine_colour_path_is_not_correct():
    over, mix = cut("colour")
    got = calibrate.train_readings("kitti360.train", tiny.SEED, CPU, True,
                                   overrides=over, mix_overrides=mix)
    assert check.judge(got["program"],
                       check.load_limits("kitti360.train"))[0]
    ok, compared = check.judge(got["control"],
                               check.load_limits("kitti360.train"))
    assert not ok, compared
    assert all(np.isfinite(v) for v in got["control"].values())


def test_recomputed_mlp_gives_the_same_steps(monkeypatch):
    """field_mlp's chunked recomputation (wide MLPs over many samples)
    follows the same steps as the whole pass."""
    over, mix_over = cut("colour")
    conf, mix = calibrate.cell_conf("kitti360.train", over, mix_over)
    conf["seed"] = tiny.SEED
    pool = traffic.train_pool(conf, dict(mix, pool=2), tiny.SEED, CPU)
    whole = follow(conf, make_weights(conf["model_conf"], tiny.SEED, CPU),
                   pool, tiny.SEED)
    monkeypatch.setattr(model, "RECOMPUTE_BYTES", 2 ** 20)
    chunked = follow(conf, make_weights(conf["model_conf"], tiny.SEED, CPU),
                     pool, tiny.SEED)
    np.testing.assert_allclose(chunked["loss"], whole["loss"], rtol=1e-6)
    np.testing.assert_allclose(chunked["grad"], whole["grad"], rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(chunked["change"], whole["change"],
                               rtol=1e-4, atol=1e-12)
