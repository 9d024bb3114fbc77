"""The port's torch-checkpoint importer (behindthescenes_tpu_torch/
import_torch.py) against the JAX package's (behindthescenes_tpu/
import_torch.py), on files the tests write from committed weights: a
torchvision-keyed ResNet-18 (`resnet18-*.pth`, the encoder of
media/weights/synthetic_conv_step8400.npz) and a reference-format BTSNet
training checkpoint (`training.pt`) of the same artifact. Both packages
read them to equal trees; the port's net then holds the artifact's values
bit for bit. Also the multi-frame conv1 tiling, the resolution order of
the pretrained encoder, and the warning against the strict error.
"""
import importlib.util
import logging
import os

import numpy as np
import pytest
import torch

from behindthescenes_tpu import import_torch as jimport
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import import_torch as timport
from behindthescenes_tpu_torch.config import find_config, load_config
from behindthescenes_tpu_torch.evaluation import harness
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.weights import (flat_from_state_dict,
                                               load_params_npz,
                                               state_dict_from_flat)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "media", "weights", "synthetic_conv_step8400.npz")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def reference_bts_checkpoint(npz: str) -> dict:
    """A reference-format training checkpoint ({"model": state dict of the
    training wrapper}, keys under `renderer.net.`) of the net in a
    Flax-keyed `.npz`."""
    return {"model": {"renderer.net." + k: v for k, v in
                      state_dict_from_flat(load_params_npz(npz)).items()}}


def _flat_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_files")
    pth = base / "resnet18-f37072fd.pth"
    torch.save(cs.torchvision_resnet_state_dict(NPZ, 18), pth)
    pt = base / "training.pt"
    torch.save(reference_bts_checkpoint(NPZ), pt)
    return {"pth": str(pth), "pt": str(pt), "base": base}


def _conf():
    return load_config(find_config("exp_synthetic"))


@pytest.mark.parametrize("frames", [1, 2])
def test_encoder_checkpoint_loads_like_jax(files, frames):
    """load_encoder_checkpoint of the torchvision file: the same tree in
    both packages, exactly; conv1 tiled over `frames` stacked frames and
    averaged."""
    want = jimport.load_encoder_checkpoint(files["pth"], 18, (0,), frames)
    got = timport.load_encoder_checkpoint(files["pth"], 18, (0,), frames)
    for w, g in zip(want, got):
        _flat_equal(timport.flatten(w), timport.flatten(g))
    kernel = got[0]["encoder"]["conv1"]["kernel"]
    assert kernel.shape == (7, 7, 3 * frames, 64)
    base = load_params_npz(NPZ)["params/encoder/encoder/conv1/kernel"]
    np.testing.assert_array_equal(kernel[:, :, :3], base / frames)


def test_pretrained_encoder_initialises_the_net(files):
    """apply_pretrained_encoder with cp_location: the port's net holds the
    artifact's encoder (parameters and BatchNorm statistics) bit for bit,
    as the JAX package's variables do after its own apply; the rest of
    the net keeps its initialisation."""
    enc = dict(_conf()["model_conf"]["encoder"], cp_location=files["pth"])
    net = BTSNet.from_conf(dict(_conf()["model_conf"], encoder=enc))
    before = flat_from_state_dict(net.state_dict(), (0,))
    assert timport.apply_pretrained_encoder(net, enc)
    got = flat_from_state_dict(net.state_dict(), (0,))
    art = load_params_npz(NPZ)
    template = j_load_npz(NPZ)
    want = jimport.apply_pretrained_encoder(
        {"params": template["params"],
         "batch_stats": template["batch_stats"]}, enc)
    jflat = {**timport.flatten(want["params"], "params/"),
             **timport.flatten(want["batch_stats"], "batch_stats/")}
    trunk = [k for k in art if k.split("/", 1)[1].startswith(
        "encoder/encoder/")]
    assert len(trunk) > 80
    for k in trunk:
        np.testing.assert_array_equal(got[k], art[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jflat[k], err_msg=k)
    for k in set(got) - set(trunk):
        np.testing.assert_array_equal(got[k], before[k], err_msg=k)


def test_resolution_order_and_the_miss(files, tmp_path, monkeypatch, caplog):
    """cp_location first, then $TORCH_HOME/hub/checkpoints/resnet18-*.pth,
    then media/weights/resnet18*.pth; each file here holds other values, so
    the one loaded shows which was found, in both packages. With none:
    a warning and False (JAX: the variables unchanged), or
    FileNotFoundError with pretrained_strict, in both."""
    sd = cs.torchvision_resnet_state_dict(NPZ, 18)
    hub = tmp_path / "torch_home" / "hub" / "checkpoints"
    media = tmp_path / "cwd" / "media" / "weights"
    hub.mkdir(parents=True)
    media.mkdir(parents=True)
    for i, path in enumerate((hub / "resnet18-0000.pth",
                              media / "resnet18_local.pth")):
        torch.save({k: v + (i + 1) if k == "conv1.weight" else v
                    for k, v in sd.items()}, path)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.chdir(tmp_path / "cwd")
    conv1 = sd["conv1.weight"]
    enc = dict(_conf()["model_conf"]["encoder"], pretrained=True)
    template = j_load_npz(NPZ)

    def loaded(enc_conf):
        net = BTSNet.from_conf(dict(_conf()["model_conf"], encoder=enc_conf))
        timport.apply_pretrained_encoder(net, enc_conf)
        got = net.encoder.encoder.encoder.conv1.weight.detach()
        want = jimport.apply_pretrained_encoder(
            {"params": template["params"],
             "batch_stats": template["batch_stats"]}, enc_conf)
        jk = want["params"]["encoder"]["encoder"]["conv1"]["kernel"]
        np.testing.assert_array_equal(got.numpy(),
                                      np.transpose(jk, (3, 2, 0, 1)))
        return float((got - conv1).mean())

    assert loaded(dict(enc, cp_location=files["pth"])) == 0.0
    assert loaded(enc) == pytest.approx(1.0)
    os.remove(hub / "resnet18-0000.pth")
    assert timport.find_encoder_checkpoint(enc).endswith(
        "resnet18_local.pth")
    assert loaded(enc) == pytest.approx(2.0)
    os.remove(media / "resnet18_local.pth")
    assert timport.find_encoder_checkpoint(enc) is None
    net = BTSNet.from_conf(dict(_conf()["model_conf"], encoder=enc))
    with caplog.at_level(logging.WARNING):
        assert not timport.apply_pretrained_encoder(net, enc)
    assert "RANDOM encoder" in caplog.text
    strict = dict(enc, pretrained_strict=True)
    for apply in (lambda: timport.apply_pretrained_encoder(net, strict),
                  lambda: jimport.apply_pretrained_encoder(
                      {"params": template["params"]}, strict)):
        with pytest.raises(FileNotFoundError, match="resnet18"):
            apply()


def test_bts_checkpoint_imports_like_jax(files):
    """import_bts_checkpoint of the reference-format `.pt`: the same
    (params, batch_stats) in both packages; loaded into the net through the
    eval harness, it gives the net the artifact's values exactly."""
    want = jimport.import_bts_checkpoint(files["pt"], 18, (0,))
    got = timport.import_bts_checkpoint(files["pt"], 18, (0,))
    for w, g in zip(want, got):
        _flat_equal(timport.flatten(w), timport.flatten(g))
    conf = _conf()
    net = BTSNet.from_conf(conf["model_conf"])
    harness.load_eval_variables({"checkpoint": files["pt"], **conf}, net)
    _flat_equal(flat_from_state_dict(net.state_dict(), (0,)),
                load_params_npz(NPZ))


def test_template_mismatch_names_the_key():
    with pytest.raises(ValueError, match="shape mismatch at a/b"):
        timport.validate_against_template({"a/b": np.zeros(3)},
                                          {"a/b": np.zeros(4)})
    with pytest.raises(ValueError, match="missing imported params"):
        timport.validate_against_template({}, {"a/b": np.zeros(4)})
