"""Weight bridge: the committed Flax `.npz` artifacts -> the port's
state_dict (inverse of behindthescenes_tpu/import_torch.py:9-13).

An artifact (written by the JAX package's `utils/io.py:save_params_npz`)
holds slash-joined Flax keys such as `params/encoder/encoder/conv1/kernel`
in f16. The port's parameters carry the reference torch checkpoints' names
(the ones `import_torch.py` reads), so this maps each key to that name and
each array to torch's layout:
  conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
  dense kernel (I, O)        -> weight (O, I)
  BatchNorm scale / bias     -> weight / bias
  batch_stats mean / var     -> running_mean / running_var
"""
from __future__ import annotations

import re

import numpy as np
import torch


def load_params_npz(path: str) -> dict:
    """Flat {flax key: float32 array} of an artifact (numpy only; the
    counterpart of utils/io.py:58-70, without nesting)."""
    with np.load(path) as data:
        return {k: data[k].astype(np.float32) if data[k].dtype == np.float16
                else data[k] for k in data.files}


_RESNET = "encoder.encoder.encoder."


def _bn_name(leaf: str) -> str:
    return {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}[leaf]


def torch_name(key: str, dispconv_scales=(0, 1, 2, 3)) -> tuple:
    """Flax key -> (torch parameter name, layout: 'conv', 'dense' or
    'plain'). Raises KeyError for a key the port does not hold."""
    parts = key.split("/")
    path, leaf = parts[1:-1], parts[-1]
    p = "/".join(path)
    if leaf == "kernel":
        kind, wname = None, "weight"
    elif leaf in ("scale", "mean", "var") or (
            leaf == "bias" and path[-1] in ("bn", "bn1")):
        kind, wname = "plain", _bn_name(leaf)
    else:
        kind, wname = "plain", leaf
    m = re.fullmatch(r"encoder/encoder/(conv1|bn1)", p)
    if m:
        return _RESNET + f"{m.group(1)}.{wname}", kind or "conv"
    m = re.fullmatch(r"encoder/encoder/layer(\d)_(\d+)/(conv\d|downsample)/"
                     r"(conv|bn)", p)
    if m:
        stage, blk, sub, part = m.groups()
        base = f"{_RESNET}layer{stage}.{blk}."
        if sub == "downsample":
            name = base + ("downsample.0." if part == "conv"
                           else "downsample.1.")
        else:
            ci = sub[-1]
            name = base + (f"conv{ci}." if part == "conv" else f"bn{ci}.")
        return name + wname, kind or "conv"
    m = re.fullmatch(r"encoder/decoder/upconv_(\d)_(\d)/conv", p)
    if m:
        idx = 2 * (4 - int(m.group(1))) + int(m.group(2))
        return f"encoder.decoder.decoder.{idx}.conv.conv.{wname}", \
            kind or "conv"
    m = re.fullmatch(r"encoder/decoder/dispconv_(\d)/conv", p)
    if m:
        idx = 10 + list(dispconv_scales).index(int(m.group(1)))
        return f"encoder.decoder.decoder.{idx}.conv.{wname}", kind or "conv"
    m = re.fullmatch(r"(mlp_coarse|mlp_fine)/(lin_in|lin_out|lin_\d+|"
                     r"block_\d+/(?:fc_0|fc_1|shortcut))", p)
    if m:
        mlp, layer = m.groups()
        layer = re.sub(r"^block_(\d+)/", r"blocks.\1.", layer)
        layer = re.sub(r"^lin_(\d+)$", r"lin\1", layer)
        return f"{mlp}.{layer}.{wname}", kind or "dense"
    if p == "" and leaf == "empty_feature":
        return "empty_feature", "plain"
    raise KeyError(f"no port parameter for artifact key {key!r}")


def _to_torch_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "dense":
        return np.transpose(arr, (1, 0))
    return arr


def state_dict_from_flat(flat: dict) -> dict:
    """Flat Flax arrays -> the port's state_dict (torch tensors, f32),
    BatchNorm's `num_batches_tracked` included."""
    scales = sorted(int(m.group(1)) for k in flat for m in
                    [re.search(r"/dispconv_(\d)/conv/kernel$", k)] if m)
    sd = {}
    for key, arr in flat.items():
        name, kind = torch_name(key, scales)
        sd[name] = torch.from_numpy(
            np.ascontiguousarray(_to_torch_layout(arr, kind)))
    for name in [n for n in sd if n.endswith(".running_mean")]:
        sd[name[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return sd


def load_weights(net: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load an artifact into `net` (strict: every parameter and buffer of
    the net must come from the file, and every array of the file must
    have a place in the net). Returns `net`."""
    net.load_state_dict(state_dict_from_flat(load_params_npz(path)),
                        strict=True)
    return net
