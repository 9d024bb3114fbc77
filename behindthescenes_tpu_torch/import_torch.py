"""PyTorch checkpoint importer (counterpart of
behindthescenes_tpu/import_torch.py).

Two kinds of torch files become the Flax-keyed flat dict that `weights.py`
loads into the port's net:
  * ImageNet backbones (torchvision `resnet{L}-*.pth`) and Monodepth2
    encoder checkpoints, for the encoder's initialisation
    (`encoder.pretrained` / `encoder.cp_location`,
    `apply_pretrained_encoder`);
  * the reference's BTS training checkpoints (`training*.pt`, keys under
    `renderer.net.`), for evaluation (`import_bts_checkpoint`).
The maps are the JAX package's, key for key: they build its nested
{params, batch_stats} subtrees, flattened to slash-joined keys.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Dict, Tuple

import numpy as np
import torch

from behindthescenes_tpu_torch.weights import (_to_torch_layout,
                                               flat_from_state_dict,
                                               state_dict_from_flat,
                                               torch_name)

log = logging.getLogger(__name__)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """{name: numpy array} of a torch checkpoint (a bare state dict, or one
    under "model")."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in ckpt.items()}


def _conv(w):
    return np.transpose(w, (2, 3, 1, 0))


def _linear(w):
    return np.transpose(w, (1, 0))


_RESNET_SPECS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}


def _map_resnet_encoder(sd, prefix, resnet_layers):
    """torchvision-style ResNet keys -> the ResnetEncoder's params and
    batch_stats subtrees."""
    params, stats = {}, {}
    params["conv1"] = {"kernel": _conv(sd[prefix + "conv1.weight"])}
    params["bn1"] = {"scale": sd[prefix + "bn1.weight"],
                     "bias": sd[prefix + "bn1.bias"]}
    stats["bn1"] = {"mean": sd[prefix + "bn1.running_mean"],
                    "var": sd[prefix + "bn1.running_var"]}
    n_convs = 3 if resnet_layers >= 50 else 2
    for stage, n_blocks in enumerate(_RESNET_SPECS[resnet_layers]):
        for b in range(n_blocks):
            tp = f"{prefix}layer{stage + 1}.{b}."
            sub_p, sub_s = {}, {}
            for ci in range(1, n_convs + 1):
                sub_p[f"conv{ci}"] = {
                    "conv": {"kernel": _conv(sd[tp + f"conv{ci}.weight"])},
                    "bn": {"scale": sd[tp + f"bn{ci}.weight"],
                           "bias": sd[tp + f"bn{ci}.bias"]}}
                sub_s[f"conv{ci}"] = {
                    "bn": {"mean": sd[tp + f"bn{ci}.running_mean"],
                           "var": sd[tp + f"bn{ci}.running_var"]}}
            if tp + "downsample.0.weight" in sd:
                sub_p["downsample"] = {
                    "conv": {"kernel": _conv(sd[tp + "downsample.0.weight"])},
                    "bn": {"scale": sd[tp + "downsample.1.weight"],
                           "bias": sd[tp + "downsample.1.bias"]}}
                sub_s["downsample"] = {
                    "bn": {"mean": sd[tp + "downsample.1.running_mean"],
                           "var": sd[tp + "downsample.1.running_var"]}}
            params[f"layer{stage + 1}_{b}"] = sub_p
            stats[f"layer{stage + 1}_{b}"] = sub_s
    return params, stats


def _map_monodepth_decoder(sd, prefix, scales=(0, 1, 2, 3)):
    """The reference decoder's ModuleList order (monodepth2.py:190-208):
    upconv_4_0, upconv_4_1, ..., upconv_0_1, then dispconv_s per scale."""
    params = {}
    idx = 0
    for i in range(4, -1, -1):
        for j in (0, 1):
            params[f"upconv_{i}_{j}"] = {"conv": {
                "kernel": _conv(sd[f"{prefix}decoder.{idx}.conv.conv.weight"]),
                "bias": sd[f"{prefix}decoder.{idx}.conv.conv.bias"]}}
            idx += 1
    for s in scales:
        params[f"dispconv_{s}"] = {"conv": {
            "kernel": _conv(sd[f"{prefix}decoder.{idx}.conv.weight"]),
            "bias": sd[f"{prefix}decoder.{idx}.conv.bias"]}}
        idx += 1
    return params


def _map_resnetfc(sd, prefix):
    params = {"lin_in": {"kernel": _linear(sd[prefix + "lin_in.weight"]),
                         "bias": sd[prefix + "lin_in.bias"]},
              "lin_out": {"kernel": _linear(sd[prefix + "lin_out.weight"]),
                          "bias": sd[prefix + "lin_out.bias"]}}
    i = 0
    while f"{prefix}blocks.{i}.fc_0.weight" in sd:
        blk = {f"fc_{j}": {
            "kernel": _linear(sd[f"{prefix}blocks.{i}.fc_{j}.weight"]),
            "bias": sd[f"{prefix}blocks.{i}.fc_{j}.bias"]} for j in (0, 1)}
        if f"{prefix}blocks.{i}.shortcut.weight" in sd:
            blk["shortcut"] = {
                "kernel": _linear(sd[f"{prefix}blocks.{i}.shortcut.weight"])}
        params[f"block_{i}"] = blk
        i += 1
    return params


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {slash-joined key: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def load_encoder_checkpoint(path: str, resnet_layers: int,
                            scales=(0, 1, 2, 3),
                            num_input_images: int = 1) -> Tuple[dict, dict]:
    """Backbone weights for the encoder's initialisation (reference
    monodepth2.py:87-92 and :275-277): a bare torchvision ResNet state
    dict (fc ignored) gives the `encoder` subtree; a Monodepth2 state dict
    (`encoder.encoder.*`, and `decoder.decoder.*` if present) gives the
    `encoder` and `decoder` subtrees. num_input_images > 1 tiles conv1
    over the stacked frames, averaged (monodepth2.py:63-66). Returns
    (params, batch_stats) shaped like the net's `encoder` entry."""
    sd = load_torch_state_dict(path)

    def tile_conv1(params):
        if num_input_images > 1:
            k = params["conv1"]["kernel"]
            params["conv1"]["kernel"] = np.concatenate(
                [k] * num_input_images, axis=2) / num_input_images
        return params

    if any(k.startswith("encoder.encoder.") for k in sd):
        enc_p, enc_s = _map_resnet_encoder(sd, "encoder.encoder.",
                                           resnet_layers)
        params = {"encoder": tile_conv1(enc_p)}
        stats = {"encoder": enc_s}
        if any(k.startswith("decoder.decoder.") for k in sd):
            params["decoder"] = _map_monodepth_decoder(sd, "decoder.", scales)
        return params, stats
    if "conv1.weight" in sd:
        enc_p, enc_s = _map_resnet_encoder(sd, "", resnet_layers)
        return {"encoder": tile_conv1(enc_p)}, {"encoder": enc_s}
    raise ValueError(f"unrecognized encoder checkpoint key schema in {path}: "
                     f"{sorted(sd)[:5]}...")


def find_encoder_checkpoint(enc_conf: dict):
    """The file `apply_pretrained_encoder` reads: `cp_location`, else (when
    `pretrained`) the first of $TORCH_HOME/hub/checkpoints/resnet{L}-*.pth
    (TORCH_HOME defaulting to ~/.cache/torch), .../resnet{L}.pth and
    media/weights/resnet{L}*.pth; None if there is none."""
    path = enc_conf.get("cp_location")
    if path is None and enc_conf.get("pretrained", False):
        layers = enc_conf.get("resnet_layers", 18)
        hub = os.path.join(os.environ.get(
            "TORCH_HOME", os.path.expanduser("~/.cache/torch")),
            "hub", "checkpoints")
        for pattern in (os.path.join(hub, f"resnet{layers}-*.pth"),
                        os.path.join(hub, f"resnet{layers}.pth"),
                        os.path.join("media", "weights",
                                     f"resnet{layers}*.pth")):
            hits = sorted(glob.glob(pattern))
            if hits:
                return hits[0]
    return path


def _copy_into(net: torch.nn.Module, flat: dict, scales) -> None:
    """Copy Flax-keyed arrays into the net's parameters and buffers, each
    shape-checked; a key with no place in the net raises."""
    own = net.state_dict()
    with torch.no_grad():
        for key, arr in flat.items():
            try:
                name, kind = torch_name(key, scales)
            except KeyError:
                raise ValueError(f"pretrained key {key} not in the model")
            if name not in own:
                raise ValueError(f"pretrained key {key} ({name}) not in the "
                                 "model")
            value = torch.from_numpy(np.ascontiguousarray(
                _to_torch_layout(np.asarray(arr, np.float32), kind)))
            if tuple(own[name].shape) != tuple(value.shape):
                raise ValueError(f"pretrained shape mismatch at {key}: "
                                 f"{tuple(value.shape)} vs model "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(value)


def apply_pretrained_encoder(net: torch.nn.Module, enc_conf: dict) -> bool:
    """Honour `encoder.pretrained` / `encoder.cp_location` on an
    initialised net (the JAX package's apply_pretrained_encoder): the
    checkpoint of `find_encoder_checkpoint` replaces the encoder's
    parameters and BatchNorm statistics it holds. With no checkpoint
    found, a warning, and training starts from the random encoder; with
    `pretrained_strict: true`, FileNotFoundError. Returns whether
    weights were loaded."""
    if enc_conf.get("type", "monodepth2") != "monodepth2":
        if enc_conf.get("pretrained") or enc_conf.get("cp_location"):
            log.warning("pretrained init only implemented for monodepth2")
        return False
    path = find_encoder_checkpoint(enc_conf)
    layers = enc_conf.get("resnet_layers", 18)
    if path is None:
        if enc_conf.get("cp_location") or enc_conf.get("pretrained"):
            msg = (f"encoder.pretrained requested but no resnet{layers} "
                   "checkpoint found (searched $TORCH_HOME/hub/checkpoints "
                   "and media/weights); training starts from RANDOM encoder "
                   "weights — accuracy will NOT reach the reference's")
            if enc_conf.get("pretrained_strict", False):
                raise FileNotFoundError(msg)
            log.warning(msg)
        return False
    scales = tuple(enc_conf.get("scales", (0, 1, 2, 3)))
    sub_p, sub_s = load_encoder_checkpoint(path, layers, scales)
    _copy_into(net, {**flatten(sub_p, "params/encoder/"),
                     **flatten(sub_s, "batch_stats/encoder/")}, scales)
    log.info("loaded pretrained encoder weights from %s", path)
    return True


def import_bts_checkpoint(path: str, resnet_layers: int = 50,
                          scales=(0, 1, 2, 3)) -> Tuple[dict, dict]:
    """-> (params, batch_stats) nested as the JAX package's BTSNet tree,
    from a reference training checkpoint (`training*.pt`) or a bare
    BTSNet state dict."""
    sd = load_torch_state_dict(path)
    # Strip the wrapper prefixes: BTSWrapper -> renderer -> net.
    for pref in ("renderer.net.", "net.", "module.renderer.net."):
        if any(k.startswith(pref) for k in sd):
            sd = {k[len(pref):]: v for k, v in sd.items()
                  if k.startswith(pref)}
            break
    enc_p, enc_s = _map_resnet_encoder(sd, "encoder.encoder.encoder.",
                                       resnet_layers)
    params = {"encoder": {"encoder": enc_p,
                          "decoder": _map_monodepth_decoder(
                              sd, "encoder.decoder.", scales)},
              "mlp_coarse": _map_resnetfc(sd, "mlp_coarse.")}
    batch_stats = {"encoder": {"encoder": enc_s}}
    if "empty_feature" in sd:
        params["empty_feature"] = sd["empty_feature"]
    if any(k.startswith("mlp_fine.") for k in sd):
        params["mlp_fine"] = _map_resnetfc(sd, "mlp_fine.")
    return params, batch_stats


def validate_against_template(flat: dict, template: dict) -> None:
    """Shape-check imported Flax-keyed arrays against a template of the
    same keys (the net's own, `flat_from_state_dict`); raises naming the
    first mismatching key, or the missing ones."""
    missing = [k for k in template if k not in flat]
    for key, t in template.items():
        if key in flat and tuple(flat[key].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {key}: imported "
                             f"{tuple(flat[key].shape)} vs template "
                             f"{tuple(t.shape)}")
    if missing:
        raise ValueError(f"missing imported params: {missing[:10]}"
                         f" (+{max(0, len(missing) - 10)} more)")


def load_bts_checkpoint(net: torch.nn.Module, path: str,
                        enc_conf: dict) -> torch.nn.Module:
    """A reference training checkpoint into `net`: imported, checked
    against the net's own keys and shapes, and loaded (arrays the net has
    no place for, such as an unused mlp_fine, are left out). Returns
    `net`."""
    scales = tuple(enc_conf.get("scales", (0, 1, 2, 3)))
    params, stats = import_bts_checkpoint(
        path, resnet_layers=enc_conf.get("resnet_layers", 50), scales=scales)
    flat = {**flatten(params, "params/"), **flatten(stats, "batch_stats/")}
    flat = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    template = flat_from_state_dict(net.state_dict(), scales)
    validate_against_template(flat, template)
    net.load_state_dict(state_dict_from_flat(
        {k: flat[k] for k in template}), strict=True)
    return net
