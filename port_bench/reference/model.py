"""Plain PyTorch reference of the model that the benchmark's cells run:
the ResNet encoder (monodepth2's decoder, or pixelNeRF's spatial
latents), the pixel-aligned field query (feature sampling, positional
code, ResnetFC MLP; colours sampled from the render views or predicted
by the MLP), the volume composite with pixelNeRF's hierarchical fine
pass through its own MLP, the patch-ray training loss (l1 + SSIM with
the minimum over views, the weight-guided invalid mask, edge-aware
smoothness) and the self-view depth of one frame.

It is written from the published model (Behind the Scenes, CVPR'23, and
its monodepth2 / pixelNeRF parts) as functions over a dict of tensors
keyed by the benchmark's parameter names, and imports nothing of the
program. Every convolution and matrix product goes through a `Precision`
(`precision.py`), so the same code runs in float32, in float64, or as the
fp8 control. Geometry, compositing and the loss's statistics run in the
input's dtype (SSIM's window statistics in float64, as the exact math).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.precision import Precision

EPS = 1e-3
# The bytes of a field MLP's saved activations (its hidden layers over
# every point) above which `field_mlp` recomputes them in the backward
# pass, a chunk of points at a time, so that a wide MLP over many samples
# fits on one card; recomputing gives the same values. Every cell's MLP
# until pixelNeRF's widths stays well under it (0.5 GiB at kitti360's).
RECOMPUTE_BYTES = 4 * 2 ** 30
RESNET = {18: ("basic", (2, 2, 2, 2), (64, 64, 128, 256, 512)),
          34: ("basic", (3, 4, 6, 3), (64, 64, 128, 256, 512)),
          50: ("bottleneck", (3, 4, 6, 3), (64, 256, 512, 1024, 2048))}


# ------------------------------------------------------------ parameters
def is_spatial(model_conf: dict) -> bool:
    """pixelNeRF's spatial encoder (else monodepth2's)."""
    return model_conf["encoder"].get("type", "monodepth2") == "spatial"


def latent_size(model_conf: dict) -> int:
    """Channels of the encoder's latent map: monodepth2's d_out, or the
    spatial encoder's concatenated trunk maps (the stem, then layer1 ...
    up to `num_layers` maps)."""
    enc = model_conf["encoder"]
    if is_spatial(model_conf):
        return sum(RESNET[enc["resnet_layers"]][2][:enc["num_layers"]])
    return enc["d_out"]


def fine_mlp(model_conf: dict) -> str:
    """The MLP that the fine pass queries: its own where `mlp_fine` is a
    ResnetFC, else the coarse one (BTSNet's `_mlp`)."""
    kind = model_conf.get("mlp_fine", {}).get("type", "empty")
    if kind not in ("resnet", "empty"):
        raise NotImplementedError(f"mlp_fine type {kind!r}")
    return "mlp_fine" if kind == "resnet" else "mlp_coarse"


def mlp_widths(model_conf: dict, name: str) -> tuple:
    """(d_in, d_hidden, d_out, n_blocks) of the ResnetFC `name`: the
    latent and the code in; the density out, and the colour with it where
    colours are not sampled from the views."""
    code = model_conf["code"]
    d_in = latent_size(model_conf) + 3 * (
        2 * code["num_freqs"] + int(code.get("include_input", True)))
    mlp = model_conf[name]
    if mlp.get("type", "resnet") != "resnet":
        raise NotImplementedError(f"{name} type {mlp.get('type')!r}")
    d_out = 1 if model_conf.get("sample_color", True) else 4
    return d_in, mlp["d_hidden"], d_out, mlp["n_blocks"]


def param_specs(model_conf: dict) -> list:
    """[(name, shape, kind)] of every tensor of the model, in a fixed
    order: the ResNet trunk (all four layers, as the program holds them),
    monodepth2's decoder, the coarse MLP and, last, a fine MLP of its
    own. kind says how `port_bench.weights` fills it: conv_he (ResNet
    convolutions), conv (decoder convolutions), bias, bn_w, bn_b,
    bn_mean, bn_var, bn_count, lin (dense weights)."""
    enc = model_conf["encoder"]
    layers = enc["resnet_layers"]
    kind, counts, ch_enc = RESNET[layers]
    specs = []
    trunk = "encoder.encoder.encoder."

    def bn(prefix, c):
        specs.extend([(prefix + ".weight", (c,), "bn_w"),
                      (prefix + ".bias", (c,), "bn_b"),
                      (prefix + ".running_mean", (c,), "bn_mean"),
                      (prefix + ".running_var", (c,), "bn_var"),
                      (prefix + ".num_batches_tracked", (), "bn_count")])

    specs.append((trunk + "conv1.weight", (64, 3, 7, 7), "conv_he"))
    bn(trunk + "bn1", 64)
    inplanes = 64
    for stage, (n, width) in enumerate(zip(counts, (64, 128, 256, 512))):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            pre = f"{trunk}layer{stage + 1}.{b}."
            if kind == "bottleneck":
                out = width * 4
                convs = [("conv1", (width, inplanes, 1, 1)),
                         ("conv2", (width, width, 3, 3)),
                         ("conv3", (out, width, 1, 1))]
            else:
                out = width
                convs = [("conv1", (width, inplanes, 3, 3)),
                         ("conv2", (width, width, 3, 3))]
            for i, (name, shape) in enumerate(convs):
                specs.append((pre + name + ".weight", shape, "conv_he"))
                bn(pre + f"bn{i + 1}", shape[0])
            if stride != 1 or inplanes != out:
                specs.append((pre + "downsample.0.weight",
                              (out, inplanes, 1, 1), "conv_he"))
                bn(pre + "downsample.1", out)
            inplanes = out
    if not is_spatial(model_conf):
        d_out = enc["d_out"]
        ch = [max(d_out, c) for c in enc["num_ch_dec"]]
        idx = 0
        for i in range(4, -1, -1):
            c_in = ch_enc[-1] if i == 4 else ch[i + 1]
            for c_a, c_b in ((c_in, ch[i]),
                             (ch[i] + (ch_enc[i - 1] if i > 0 else 0),
                              ch[i])):
                pre = f"encoder.decoder.decoder.{idx}.conv.conv."
                specs += [(pre + "weight", (c_b, c_a, 3, 3), "conv"),
                          (pre + "bias", (c_b,), "bias")]
                idx += 1
        specs += [("encoder.decoder.decoder.10.conv.weight",
                   (d_out, ch[0], 3, 3), "conv"),
                  ("encoder.decoder.decoder.10.conv.bias", (d_out,), "bias")]
    for name in dict.fromkeys(["mlp_coarse", fine_mlp(model_conf)]):
        d_in, hid, d_out, blocks = mlp_widths(model_conf, name)
        specs += [(name + ".lin_in.weight", (hid, d_in), "lin"),
                  (name + ".lin_in.bias", (hid,), "bias"),
                  (name + ".lin_out.weight", (d_out, hid), "lin"),
                  (name + ".lin_out.bias", (d_out,), "bias")]
        for b in range(blocks):
            pre = f"{name}.blocks.{b}."
            specs += [(pre + "fc_0.weight", (hid, hid), "lin"),
                      (pre + "fc_0.bias", (hid,), "bias"),
                      (pre + "fc_1.weight", (hid, hid), "lin"),
                      (pre + "fc_1.bias", (hid,), "bias")]
    return specs


# --------------------------------------------------------------- encoder
def _bn(p, prefix, x, train):
    if train:
        return F.batch_norm(x, None, None, p[prefix + ".weight"],
                            p[prefix + ".bias"], True, 0.0, 1e-5)
    return F.batch_norm(x, p[prefix + ".running_mean"],
                        p[prefix + ".running_var"], p[prefix + ".weight"],
                        p[prefix + ".bias"], False, 0.0, 1e-5)


def _block(p, pre, x, stride, kind, train, prec):
    if kind == "bottleneck":
        out = torch.relu(_bn(p, pre + "bn1", prec.conv2d(
            x, p[pre + "conv1.weight"]), train))
        out = torch.relu(_bn(p, pre + "bn2", prec.conv2d(
            out, p[pre + "conv2.weight"], stride=stride, padding=1), train))
        out = _bn(p, pre + "bn3", prec.conv2d(out, p[pre + "conv3.weight"]),
                  train)
    else:
        out = torch.relu(_bn(p, pre + "bn1", prec.conv2d(
            x, p[pre + "conv1.weight"], stride=stride, padding=1), train))
        out = _bn(p, pre + "bn2", prec.conv2d(
            out, p[pre + "conv2.weight"], padding=1), train)
    if pre + "downsample.0.weight" in p:
        x = _bn(p, pre + "downsample.1", prec.conv2d(
            x, p[pre + "downsample.0.weight"], stride=stride), train)
    return torch.relu(out + x)


def _conv3x3_reflect(p, pre, x, prec):
    return prec.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                       p[pre + "weight"], p[pre + "bias"])


def _trunk(p, x, kind, counts, train, prec) -> list:
    """The ResNet over x: [the stem's map at stride 2, then each stage's
    map in turn for the stages in `counts`] (the max pool before the
    first stage)."""
    trunk = "encoder.encoder.encoder."
    feats = [torch.relu(_bn(p, trunk + "bn1", prec.conv2d(
        x, p[trunk + "conv1.weight"], stride=2, padding=3), train))]
    x = feats[0]
    if counts:
        x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in enumerate(counts):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            x = _block(p, f"{trunk}layer{stage + 1}.{b}.", x, stride, kind,
                       train, prec)
        feats.append(x)
    return feats


def spatial_input(images):
    """What pixelNeRF's ResNet is fed: the images in [-1, 1] as they are
    (its loaders normalise to [-1, 1]; the encoder adds nothing)."""
    return images


def spatial_resize(f, size):
    """pixelNeRF's resize of a trunk map to the stem's size: bilinear,
    align_corners=True (its upsample_interp default)."""
    return F.interpolate(f, size, mode="bilinear", align_corners=True)


def encode(p, images, model_conf: dict, train: bool, prec: Precision):
    """images (n, 3, h, w) in [-1, 1] -> the scale-0 latent map (n,
    latent_size, h', w'), BatchNorm on batch statistics when `train`.
    monodepth2: the ResNet trunk on ImageNet-normalised [0, 1] images,
    then its decoder (reflect-padded 3x3 convolutions, ELU, nearest x2
    upsampling, skips), at full size. spatial (pixelNeRF's
    SpatialEncoder): the stem and the stages up to `num_layers` maps in
    all (no later stage runs), each resized to the stem's half size and
    concatenated on channels."""
    enc = model_conf["encoder"]
    kind, counts, _ = RESNET[enc["resnet_layers"]]
    if is_spatial(model_conf):
        feats = _trunk(p, spatial_input(images), kind,
                       counts[:enc["num_layers"] - 1], train, prec)
        size = feats[0].shape[-2:]
        return torch.cat([spatial_resize(f, size) for f in feats], 1)
    x = ((images * 0.5 + 0.5) - 0.45) / 0.225
    feats = _trunk(p, x, kind, counts, train, prec)
    x = feats[-1]
    for n, i in enumerate(range(4, -1, -1)):
        pre = "encoder.decoder.decoder."
        x = F.elu(_conv3x3_reflect(p, f"{pre}{2 * n}.conv.conv.", x, prec))
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if i > 0:
            skip = feats[i - 1]
            x = torch.cat([x[:, :, :skip.shape[2], :skip.shape[3]], skip], 1)
        x = F.elu(_conv3x3_reflect(p, f"{pre}{2 * n + 1}.conv.conv.", x,
                                   prec))
    return _conv3x3_reflect(p, "encoder.decoder.decoder.10.conv.", x, prec)


# ----------------------------------------------------------------- field
def posenc(x, num_freqs: int, freq_factor: float, include_input: bool):
    """NeRF code of x (..., d): [x, sin(f_0 x), cos(f_0 x), sin(f_1 x),
    ...] with f_k = freq_factor 2^k, each block d wide."""
    freqs = freq_factor * 2.0 ** torch.arange(num_freqs, dtype=x.dtype,
                                              device=x.device)
    s = x[..., None, :] * freqs[:, None]
    emb = torch.stack([torch.sin(s), torch.cos(s)], -2).flatten(-3)
    return torch.cat([x, emb], -1) if include_input else emb


def code_coord(coord, model_conf: dict):
    """Depth (camera z or distance) -> the code's input in [-1, 1]."""
    near, far = model_conf["z_near"], model_conf["z_far"]
    if model_conf.get("inv_z", True):
        coord = (1.0 / torch.clamp_min(coord, EPS) - 1.0 / far) \
            / (1.0 / near - 1.0 / far)
    else:
        coord = (coord - near) / (far - near)
    return 2.0 * coord - 1.0


def mlp(p, x, model_conf: dict, prec: Precision, name: str = "mlp_coarse"):
    """The ResnetFC `name` (relu): lin_in, n_blocks residual blocks,
    lin_out; returns its raw output (..., d_out)."""
    h = prec.linear(x, p[name + ".lin_in.weight"], p[name + ".lin_in.bias"])
    for b in range(model_conf[name]["n_blocks"]):
        pre = f"{name}.blocks.{b}."
        net = prec.linear(torch.relu(h), p[pre + "fc_0.weight"],
                          p[pre + "fc_0.bias"])
        h = h + prec.linear(torch.relu(net), p[pre + "fc_1.weight"],
                            p[pre + "fc_1.bias"])
    return prec.linear(torch.relu(h), p[name + ".lin_out.weight"],
                       p[name + ".lin_out.bias"])


def field_mlp(p, x, model_conf: dict, prec: Precision,
              name: str = "mlp_coarse"):
    """`mlp` over points x (..., d_in); where its saved activations would
    pass RECOMPUTE_BYTES, in chunks of points under
    torch.utils.checkpoint (each chunk's about a quarter of that)."""
    _, hid, _, blocks = mlp_widths(model_conf, name)
    per_point = x.element_size() * hid * (2 + 4 * blocks)
    flat = x.reshape(-1, x.shape[-1])
    if not torch.is_grad_enabled() \
            or flat.shape[0] * per_point <= RECOMPUTE_BYTES:
        return mlp(p, x, model_conf, prec, name)
    step = max(1, RECOMPUTE_BYTES // (4 * per_point))

    def part(chunk):
        return mlp(p, chunk, model_conf, prec, name)
    out = torch.cat([checkpoint(part, flat[i:i + step], use_reentrant=False)
                     for i in range(0, flat.shape[0], step)])
    return out.reshape(x.shape[:-1] + out.shape[-1:])


def density(out, model_conf: dict):
    """The density (...) of an MLP output (..., d_out): softplus where the
    colours are sampled from the views, relu where the MLP predicts them
    (BTS models_bts.py:311-321)."""
    if model_conf.get("sample_color", True):
        return F.softplus(out)[..., 0]
    return torch.relu(out[..., 0])


def project(points, w2c, k):
    """World points (n, P, 3) into cameras w2c (n, 4, 4), NDC intrinsics
    k (n, 3, 3) -> xy (n, P, 2), camera z, distance (n, P) and the
    invalid mask (n, P) (behind the camera or outside the image)."""
    cam = torch.einsum("npj,nij->npi", points, w2c[:, :3, :3]) \
        + w2c[:, None, :3, 3]
    uvw = torch.einsum("npj,nij->npi", cam, k)
    z = uvw[..., 2]
    xy = uvw[..., :2] / torch.clamp_min(z, EPS)[..., None]
    invalid = (z <= EPS) | (xy.abs() > 1).any(-1)
    return xy, z, cam.norm(dim=-1), invalid


def sample_map(img, xy):
    """Bilinear, border padding, align_corners=False: img (n, c, h, w),
    xy (n, P, 2) -> (n, P, c)."""
    return F.grid_sample(img, xy[:, :, None, :], mode="bilinear",
                         padding_mode="border",
                         align_corners=False)[..., 0].transpose(1, 2)


def query(p, feats, points, f_w2c, f_k, colors, c_w2c, c_k,
          model_conf: dict, prec: Precision, name: str = "mlp_coarse"):
    """The cross-view field at points (n, P, 3) through the MLP `name`:
    density from the encoder view's features and code; colours and
    validity from the render views, or, where the MLP predicts colour
    (`sample_color` false), its sigmoid(out[1:4]) as the one view, valid
    where the encoder view sees the point. feats (n, c, h, w); colors
    (n, nr, 3, h, w); c_w2c (n, nr, 4, 4). Returns sigma (n, P), rgb (n,
    P, views, 3), invalid (n, P, views) bool."""
    code = model_conf["code"]
    xy, z, dist, inv_f = project(points, f_w2c, f_k)
    coord = code_coord(z if model_conf.get("code_mode", "z") == "z"
                       else dist, model_conf)
    x = torch.cat([sample_map(feats, xy),
                   posenc(prec.code_input(torch.cat([xy, coord[..., None]],
                                                    -1)),
                          code["num_freqs"], code["freq_factor"],
                          code.get("include_input", True))], -1)
    out = field_mlp(p, x, model_conf, prec, name)
    sigma = density(out, model_conf)
    if not model_conf.get("sample_color", True):
        return sigma, torch.sigmoid(out[..., 1:4])[:, :, None], \
            inv_f[..., None]
    rgbs, invs = [], []
    for r in range(colors.shape[1]):
        xy_r, _, _, inv_r = project(points, c_w2c[:, r], c_k[:, r])
        rgbs.append(sample_map(colors[:, r], xy_r))
        invs.append(inv_r | inv_f)
    return sigma, torch.stack(rgbs, 2), torch.stack(invs, -1)


def composite_weights(sigma, deltas_z, hard_alpha_cap: bool):
    """Alpha-compositing weights of densities sigma (..., K) at sample
    distances deltas_z (..., K) along each ray."""
    deltas = deltas_z[..., 1:] - deltas_z[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], -1)
    alphas = 1.0 - torch.exp(-deltas.abs() * torch.relu(sigma))
    if hard_alpha_cap:
        alphas = torch.cat([alphas[..., :-1],
                            torch.ones_like(alphas[..., -1:])], -1)
    log_t = torch.cumsum(torch.log(torch.clamp_min(1.0 - alphas, 1e-10)),
                         -1)
    log_t = torch.cat([torch.zeros_like(log_t[..., :1]), log_t[..., :-1]],
                      -1)
    return alphas * torch.exp(log_t)


# ------------------------------------------------------------------ loss
_GAUSS3 = ((0.0947, 0.1183, 0.0947), (0.1183, 0.1478, 0.1183),
           (0.0947, 0.1183, 0.0947))


def ssim_error(a, b):
    """(1 - SSIM) / 2 clamped, zero-padded 3x3 gaussian window, statistics
    in float64: a, b (N, c, h, w) -> (N, c, h, w) in a's dtype."""
    dt = a.dtype
    a = F.pad(a.double(), (1, 1, 1, 1))
    b = F.pad(b.double(), (1, 1, 1, 1))
    c = a.shape[1]
    win = torch.tensor(_GAUSS3, dtype=torch.float32).double().to(a.device)
    win = win.expand(c, 1, 3, 3)

    def avg(t):
        return F.conv2d(t, win, groups=c)
    mu_a, mu_b = avg(a), avg(b)
    var_a = avg(a * a) - mu_a * mu_a
    var_b = avg(b * b) - mu_b * mu_b
    cov = avg(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)))
    return (torch.clamp(1.0 - s, 0.0, 1.0) * 0.5).to(dt)


def _photometric(rgb, rgb_gt, weights, invalid):
    """(the mean photometric error, the invalid rays) of one render
    branch: per view 0.85 SSIM + 0.15 L1, the minimum over the views,
    rays whose weight sits over 90% on invalid samples in every view left
    out (as zero). Shapes as `patch_loss`'s."""
    n, pc, ph, pw, nr, c = rgb.shape
    a = rgb.permute(0, 1, 4, 5, 2, 3).reshape(-1, c, ph, pw)
    b = rgb_gt[:, :, None].expand(n, pc, nr, ph, pw, c) \
        .permute(0, 1, 2, 5, 3, 4).reshape(-1, c, ph, pw)
    err = 0.85 * ssim_error(a, b).mean(1) + 0.15 * (a - b).abs().mean(1)
    err = err.reshape(n, pc, nr, ph, pw).amin(2)
    mass = (invalid.to(weights.dtype) * weights[..., None]).sum(-2)
    invalid_ray = (mass > 0.9).all(-1)
    return (err * (1.0 - invalid_ray.to(err.dtype))).mean(), invalid_ray


def patch_loss(rgb, rgb_gt, weights, invalid, depth, loss_conf: dict,
               fine=None):
    """The reconstruction loss of patch rays (BTS's ReconstructionLoss).
    rgb (n, pc, p, p, nr, 3); rgb_gt (n, pc, p, p, 3); weights (n, pc, p,
    p, K); invalid (n, pc, p, p, K, nr) bool; depth (n, pc, p, p): the
    coarse render. fine: (rgb, weights, invalid) of the fine render, its
    invalid rays its own; without one the fine branch is a copy of the
    coarse and its term the coarse term again. lambda_coarse times the
    coarse term, lambda_fine times the fine term (both 1 by default),
    plus lambda_edge_aware_smoothness times the edge-aware smoothness of
    the coarse depth over the coarse branch's valid rays. Returns (the
    loss, {"loss_rgb": the coarse photometric mean, "loss_eas": the
    smoothness mean})."""
    rgb_loss, invalid_ray = _photometric(rgb, rgb_gt, weights, invalid)
    lam_c = loss_conf.get("lambda_coarse", 1.0)
    lam_f = loss_conf.get("lambda_fine", 1.0)
    if fine is None:
        photo = (lam_c + lam_f) * rgb_loss
    else:
        photo = lam_c * rgb_loss + lam_f * _photometric(
            fine[0], rgb_gt, fine[1], fine[2])[0]
    disp = 1.0 / torch.clamp(depth, 1e-3, 80.0)
    disp = disp / disp.mean(dim=(-2, -1), keepdim=True)
    d_dx = (disp[..., :, :-1] - disp[..., :, 1:]).abs() * torch.exp(
        -(rgb_gt[..., :, :-1, :] - rgb_gt[..., :, 1:, :]).abs().mean(-1))
    d_dy = (disp[..., :-1, :] - disp[..., 1:, :]).abs() * torch.exp(
        -(rgb_gt[..., :-1, :, :] - rgb_gt[..., 1:, :, :]).abs().mean(-1))
    eas = (F.pad(d_dx, (0, 1)) + F.pad(d_dy, (0, 0, 0, 1))) \
        * (1.0 - invalid_ray.to(rgb_loss.dtype))
    eas = eas.mean()
    lam_eas = loss_conf.get("lambda_edge_aware_smoothness", 0.0)
    return photo + lam_eas * eas, {"loss_rgb": rgb_loss, "loss_eas": eas}


# ------------------------------------------------------------- the paths
def ndc_lattice(h: int, w: int, dtype, device):
    """Pixel centres in NDC: linspace(-1, 1) over each axis."""
    return (torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device),
            torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device))


def train_loss(p, batch: dict, ids: dict, draws: dict, conf: dict,
               prec: Precision):
    """The loss of one training micro-step and its terms (`patch_loss`).
    batch: imgs (n, v, h, w, 3)
    in [-1, 1], poses (n, v, 4, 4) camera-to-world, projs (n, v, 3, 3)
    NDC; ids: "render", "loss" (view indices, the encoder view is 0);
    draws: "flip" (bool), "views", "ys", "xs" (n, pc) patch choices among
    the loss views, "z_jitter" (n, R, K) in [0, 1) and, with a fine pass,
    "fine_u", "fine_jitter" (n, R, n_fine - n_fine_depth) in [0, 1) and
    "fine_normals" (n, R, n_fine_depth) standard normal.

    The fine pass is pixelNeRF's (nerf.py's sample_fine,
    sample_fine_depth): importance samples from the inverse CDF of the
    coarse weights (detached, + 1e-5), a bin by u and a place in it by
    the jitter; samples at the coarse depth plus normals x depth_std,
    clamped to [near, far] (the depth not detached: its gradient flows
    on, in pixelNeRF as in the program); all sorted with the coarse
    samples and queried through the fine MLP."""
    mc, rc = conf["model_conf"], conf["renderer"]
    imgs, projs = batch["imgs"], batch["projs"]
    n, v, h, w, _ = imgs.shape
    dev, dt = imgs.device, imgs.dtype
    poses = torch.linalg.inv(batch["poses"][:, :1]) @ batch["poses"]
    w2c = torch.linalg.inv(poses)
    colors01 = imgs * 0.5 + 0.5
    x = imgs[:, 0].permute(0, 3, 1, 2)
    if draws["flip"]:
        x = x.flip(3)
    feats = encode(p, x, mc, True, prec)
    if draws["flip"]:
        feats = feats.flip(3)
    ps = mc["patch_size"]
    il = torch.as_tensor(ids["loss"], device=dev)
    ir = torch.as_tensor(ids["render"], device=dev)
    xs_l, ys_l = ndc_lattice(h, w, dt, dev)
    d = torch.arange(ps, device=dev)
    yy = (draws["ys"][:, :, None, None] + d[:, None]).expand(-1, -1, ps, ps)
    xx = (draws["xs"][:, :, None, None] + d[None, :]).expand(-1, -1, ps, ps)
    view = il[draws["views"]][:, :, None, None].expand(-1, -1, ps, ps)
    item = torch.arange(n, device=dev)[:, None, None, None].expand_as(view)
    k_r, pose_r = projs[item, view], poses[item, view]
    dirs = torch.stack([(xs_l[xx] - k_r[..., 0, 2]) / k_r[..., 0, 0],
                        (ys_l[yy] - k_r[..., 1, 2]) / k_r[..., 1, 1],
                        torch.ones_like(k_r[..., 0, 0])], -1)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    dirs = (pose_r[..., :3, :3] @ dirs[..., None])[..., 0].reshape(n, -1, 3)
    origins = pose_r[..., :3, 3].reshape(n, -1, 3)
    rgb_gt = colors01[item, view, yy, xx]                # (n, pc, p, p, 3)
    k = rc["n_coarse"]
    near, far = float(mc["z_near"]), float(mc["z_far"])
    lindisp = rc.get("lindisp", True)

    def steps_to_z(s):
        if lindisp:
            return 1.0 / (1.0 / near * (1.0 - s) + 1.0 / far * s)
        return near * (1.0 - s) + far * s

    r = origins.shape[1]
    pc = r // (ps * ps)
    shp = (n, pc, ps, ps)

    def render(z, name):
        """(rgb, weights, invalid) of the samples z (n, R, K') through the
        MLP `name`, in the loss's patch shapes."""
        kk = z.shape[-1]
        pts = origins[:, :, None] + z[..., None] * dirs[:, :, None]
        sigma, rgbs, invalid = query(
            p, feats, pts.reshape(n, r * kk, 3), w2c[:, 0], projs[:, 0],
            colors01[:, ir].permute(0, 1, 4, 2, 3), w2c[:, ir], projs[:, ir],
            mc, prec, name)
        nv = rgbs.shape[2]
        weights = composite_weights(sigma.reshape(n, r, kk), z,
                                    rc.get("hard_alpha_cap", False))
        rgb = (weights[..., None, None] * rgbs.reshape(n, r, kk, nv, 3)) \
            .sum(2)
        return (rgb.reshape(shp + (nv, 3)), weights,
                invalid.reshape(shp + (kk, nv)))

    s = torch.arange(k, dtype=dt, device=dev) / k + draws["z_jitter"] / k
    z = steps_to_z(s)                                    # (n, R, K)
    rgb, weights, invalid = render(z, "mlp_coarse")
    depth = (weights * z).sum(-1)
    fine = None
    n_fine, n_depth = rc.get("n_fine", 0), rc.get("n_fine_depth", 0)
    if n_fine > 0:
        new = []
        if n_fine > n_depth:
            wts = weights.detach() + 1e-5
            cdf = torch.cumsum(wts / wts.sum(-1, keepdim=True), -1)
            cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
            inds = torch.searchsorted(cdf, draws["fine_u"].contiguous(),
                                      right=True).to(dt) - 1.0
            new.append(steps_to_z((torch.clamp_min(inds, 0.0)
                                   + draws["fine_jitter"]) / k))
        if n_depth > 0:
            new.append(torch.clamp(
                depth[..., None] + draws["fine_normals"]
                * rc.get("depth_std", 0.01), near, far))
        z_fine = torch.sort(torch.cat([z] + new, -1), dim=-1,
                            stable=True).values
        rgb_f, weights_f, invalid_f = render(z_fine, fine_mlp(mc))
        fine = (rgb_f, weights_f.reshape(shp + (z_fine.shape[-1],)),
                invalid_f)
    return patch_loss(rgb, rgb_gt, weights.reshape(shp + (k,)), invalid,
                      depth.reshape(shp), conf["loss"], fine)


def selfview_depth(p, image, proj, conf: dict, prec: Precision,
                   rows: int = 8192):
    """z-depth (h, w) of one frame through its own camera: image (h, w, 3)
    in [-1, 1], proj (3, 3). BatchNorm on running statistics; every pixel's
    ray sampled on one camera-z ladder at the bin midpoints, density from
    the pixel's feature and the code of (x, y, z) through the coarse MLP's
    density head, composited over each ray's distances; computed in
    blocks of `rows` pixels."""
    mc, rc = conf["model_conf"], conf["renderer"]
    code = mc["code"]
    h, w, _ = image.shape
    dev, dt = image.device, image.dtype
    feats = encode(p, image.permute(2, 0, 1)[None], mc, False, prec)
    k = rc["n_coarse"]
    near, far = float(mc["z_near"]), float(mc["z_far"])
    s = (torch.arange(k, dtype=dt, device=dev) + 0.5) / k
    z_cam = 1.0 / (1.0 / near * (1.0 - s) + 1.0 / far * s) \
        if rc.get("lindisp", True) else near * (1.0 - s) + far * s
    xs, ys = ndc_lattice(h, w, dt, dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    xy = torch.stack([gx, gy], -1).reshape(-1, 2)
    norms = torch.stack([(xy[:, 0] - proj[0, 2]) / proj[0, 0],
                         (xy[:, 1] - proj[1, 2]) / proj[1, 1],
                         torch.ones_like(xy[:, 0])], -1).norm(dim=-1)
    zc = code_coord(z_cam, mc)
    depth = []
    for lo in range(0, h * w, rows):
        xy_b = xy[lo:lo + rows]
        b = xy_b.shape[0]
        f = sample_map(feats, xy_b[None])[0]             # (b, c)
        inp = prec.code_input(torch.cat([xy_b[:, None].expand(b, k, 2),
                                         zc[None, :, None].expand(b, k, 1)],
                                        -1))
        x = torch.cat([f[:, None].expand(b, k, f.shape[-1]),
                       posenc(inp, code["num_freqs"], code["freq_factor"],
                              code.get("include_input", True))], -1)
        sigma = density(mlp(p, x, mc, prec), mc)
        wts = composite_weights(sigma, z_cam[None] * norms[lo:lo + rows,
                                                           None],
                                rc.get("hard_alpha_cap", False))
        depth.append((wts * z_cam).sum(-1))
    return torch.cat(depth).reshape(h, w)


def adam_step(params: dict, grads: dict, state: dict, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam update in place (eps outside the square root, bias
    correction by the count of updates)."""
    t = state.setdefault("t", 0) + 1
    state["t"] = t
    for name, g in grads.items():
        m = state.setdefault("m." + name, torch.zeros_like(g))
        v = state.setdefault("v." + name, torch.zeros_like(g))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        params[name].data.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    return state
