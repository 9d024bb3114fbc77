"""Weight bridge between the committed Flax `.npz` artifacts and the port's
state_dict, both ways (inverse of behindthescenes_tpu/import_torch.py:9-13).

An artifact (written by the JAX package's `utils/io.py:save_params_npz`)
holds slash-joined Flax keys such as `params/encoder/encoder/conv1/kernel`
in f16. The port's parameters carry the reference torch checkpoints' names
(the ones `import_torch.py` reads), so this maps each key to that name and
each array to torch's layout:
  conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
  dense kernel (I, O)        -> weight (O, I)
  BatchNorm scale / bias     -> weight / bias
  batch_stats mean / var     -> running_mean / running_var
`flat_from_state_dict` maps back, so the port writes checkpoints that the
JAX package's `utils/io.load_params_npz` reads.
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
    if p == "encoder/fc":                 # ImageEncoder's dense layer
        return f"encoder.fc.{wname}", kind or "dense"
    if p == "" and leaf == "empty_feature":
        return "empty_feature", "plain"
    if p == "encoder" and leaf == "feats":
        return "encoder.feats", "plain"
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


_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}


def flax_key(name: str, dispconv_scales=(0, 1, 2, 3)) -> tuple:
    """The port's parameter name -> (Flax key, layout): the inverse of
    `torch_name`. Raises KeyError for a name with no Flax counterpart."""
    parts = name.split(".")
    leaf = parts[-1]
    m = re.fullmatch(r"encoder\.encoder\.encoder\.(.+)\.(\w+)", name)
    if m:
        mod, leaf = m.groups()
        m2 = re.fullmatch(r"layer(\d)\.(\d+)\.(conv|bn)(\d)", mod)
        m3 = re.fullmatch(r"layer(\d)\.(\d+)\.downsample\.([01])", mod)
        if mod in ("conv1", "bn1"):
            path, is_bn = f"encoder/encoder/{mod}", mod == "bn1"
        elif m2:
            stage, blk, part, ci = m2.groups()
            is_bn = part == "bn"
            path = (f"encoder/encoder/layer{stage}_{blk}/conv{ci}/"
                    + ("bn" if is_bn else "conv"))
        elif m3:
            stage, blk, part = m3.groups()
            is_bn = part == "1"
            path = (f"encoder/encoder/layer{stage}_{blk}/downsample/"
                    + ("bn" if is_bn else "conv"))
        else:
            raise KeyError(name)
        if is_bn:
            coll, fleaf = _BN_LEAF[leaf]
            return f"{coll}/{path}/{fleaf}", "plain"
        return f"params/{path}/kernel", "conv"
    m = re.fullmatch(r"encoder\.decoder\.decoder\.(\d+)\.conv(\.conv)?\."
                     r"(weight|bias)", name)
    if m:
        idx, leaf = int(m.group(1)), m.group(3)
        path = f"dispconv_{dispconv_scales[idx - 10]}" if idx >= 10 \
            else f"upconv_{4 - idx // 2}_{idx % 2}"
        fleaf, kind = ("kernel", "conv") if leaf == "weight" \
            else ("bias", "plain")
        return f"params/encoder/decoder/{path}/conv/{fleaf}", kind
    m = re.fullmatch(r"(mlp_coarse|mlp_fine)\.(.+)\.(weight|bias)", name)
    if m:
        mlp, layer, leaf = m.groups()
        layer = re.sub(r"^blocks\.(\d+)\.", r"block_\1/", layer)
        layer = re.sub(r"^lin(\d+)$", r"lin_\1", layer)
        fleaf, kind = ("kernel", "dense") if leaf == "weight" \
            else ("bias", "plain")
        return f"params/{mlp}/{layer}/{fleaf}", kind
    m = re.fullmatch(r"encoder\.fc\.(weight|bias)", name)
    if m:
        return (("params/encoder/fc/kernel", "dense") if m.group(1) == "weight"
                else ("params/encoder/fc/bias", "plain"))
    if name == "empty_feature":
        return "params/empty_feature", "plain"
    if name == "encoder.feats":
        return "params/encoder/feats", "plain"
    raise KeyError(f"no Flax key for port parameter {name!r}")


def flat_from_state_dict(sd: dict, dispconv_scales=(0, 1, 2, 3)) -> dict:
    """The port's state_dict (or a dict of per-parameter gradients under
    the same names) -> flat {Flax key: float32 numpy array} in Flax's
    layout; `num_batches_tracked` has no Flax counterpart and is dropped.
    dispconv_scales: the decoder's scales (its 10th, 11th... entries).
    The arrays are copies: they do not follow the tensors' later
    changes."""
    flat = {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        key, kind = flax_key(name, dispconv_scales)
        arr = t.detach().float().cpu().numpy()
        if kind == "conv":
            arr = np.transpose(arr, (2, 3, 1, 0))
        elif kind == "dense":
            arr = np.transpose(arr, (1, 0))
        flat[key] = np.array(arr, order="C", copy=True)
    return flat


def save_params_npz(path: str, sd: dict, dispconv_scales=(0, 1, 2, 3)):
    """Write the port's state_dict as a Flax-keyed f32 `.npz` that the JAX
    package's `utils/io.load_params_npz` reads (the committed artifacts
    are f16; a training checkpoint keeps f32)."""
    np.savez_compressed(path, **flat_from_state_dict(sd, dispconv_scales))


def load_weights(net: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load an artifact into `net` (strict: every parameter and buffer of
    the net must come from the file, and every array of the file must
    have a place in the net). Returns `net`."""
    net.load_state_dict(state_dict_from_flat(load_params_npz(path)),
                        strict=True)
    return net
