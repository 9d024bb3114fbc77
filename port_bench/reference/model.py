"""Plain PyTorch reference of the model that the benchmark's cells run:
the ResNet monodepth2 encoder, the pixel-aligned field query (feature
sampling, positional code, ResnetFC MLP), the volume composite, the
patch-ray training loss (l1 + SSIM with the minimum over views, the
weight-guided invalid mask, edge-aware smoothness) and the self-view
depth of one frame.

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

from port_bench.reference.precision import Precision

EPS = 1e-3
RESNET = {18: ("basic", (2, 2, 2, 2), (64, 64, 128, 256, 512)),
          34: ("basic", (3, 4, 6, 3), (64, 64, 128, 256, 512)),
          50: ("bottleneck", (3, 4, 6, 3), (64, 256, 512, 1024, 2048))}


# ------------------------------------------------------------ parameters
def param_specs(model_conf: dict) -> list:
    """[(name, shape, kind)] of every tensor of the model, in a fixed
    order. kind says how `port_bench.weights` fills it: conv_he (ResNet
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
    d_out = enc["d_out"]
    ch = [max(d_out, c) for c in enc["num_ch_dec"]]
    idx = 0
    for i in range(4, -1, -1):
        c_in = ch_enc[-1] if i == 4 else ch[i + 1]
        for c_a, c_b in ((c_in, ch[i]),
                         (ch[i] + (ch_enc[i - 1] if i > 0 else 0), ch[i])):
            pre = f"encoder.decoder.decoder.{idx}.conv.conv."
            specs += [(pre + "weight", (c_b, c_a, 3, 3), "conv"),
                      (pre + "bias", (c_b,), "bias")]
            idx += 1
    specs += [("encoder.decoder.decoder.10.conv.weight",
               (d_out, ch[0], 3, 3), "conv"),
              ("encoder.decoder.decoder.10.conv.bias", (d_out,), "bias")]
    code = model_conf["code"]
    d_in = d_out + 3 * (2 * code["num_freqs"]
                        + int(code.get("include_input", True)))
    mlp = model_conf["mlp_coarse"]
    hid = mlp["d_hidden"]
    specs += [("mlp_coarse.lin_in.weight", (hid, d_in), "lin"),
              ("mlp_coarse.lin_in.bias", (hid,), "bias"),
              ("mlp_coarse.lin_out.weight", (1, hid), "lin"),
              ("mlp_coarse.lin_out.bias", (1,), "bias")]
    for b in range(mlp["n_blocks"]):
        pre = f"mlp_coarse.blocks.{b}."
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


def encode(p, images, model_conf: dict, train: bool, prec: Precision):
    """images (n, 3, h, w) in [-1, 1] -> the scale-0 latent map (n, d_out,
    h, w): ResNet trunk (BatchNorm on batch statistics when `train`),
    then the monodepth2 decoder (reflect-padded 3x3 convolutions, ELU,
    nearest x2 upsampling, skips)."""
    enc = model_conf["encoder"]
    kind, counts, _ = RESNET[enc["resnet_layers"]]
    trunk = "encoder.encoder.encoder."
    x = ((images * 0.5 + 0.5) - 0.45) / 0.225
    feats = [torch.relu(_bn(p, trunk + "bn1", prec.conv2d(
        x, p[trunk + "conv1.weight"], stride=2, padding=3), train))]
    x = F.max_pool2d(feats[0], 3, 2, 1)
    for stage, n in enumerate(counts):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            x = _block(p, f"{trunk}layer{stage + 1}.{b}.", x, stride, kind,
                       train, prec)
        feats.append(x)
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


def mlp(p, x, model_conf: dict, prec: Precision):
    """ResnetFC (relu): lin_in, n_blocks residual blocks, lin_out on the
    density column; returns the softplus density (..., 1)."""
    h = prec.linear(x, p["mlp_coarse.lin_in.weight"],
                    p["mlp_coarse.lin_in.bias"])
    for b in range(model_conf["mlp_coarse"]["n_blocks"]):
        pre = f"mlp_coarse.blocks.{b}."
        net = prec.linear(torch.relu(h), p[pre + "fc_0.weight"],
                          p[pre + "fc_0.bias"])
        h = h + prec.linear(torch.relu(net), p[pre + "fc_1.weight"],
                            p[pre + "fc_1.bias"])
    out = prec.linear(torch.relu(h), p["mlp_coarse.lin_out.weight"],
                      p["mlp_coarse.lin_out.bias"])
    return F.softplus(out)


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
          model_conf: dict, prec: Precision):
    """The cross-view field at points (n, P, 3): density from the encoder
    view's features and code, colours and validity from the render views.
    feats (n, c, h, w); colors (n, nr, 3, h, w); c_w2c (n, nr, 4, 4).
    Returns sigma (n, P), rgb (n, P, nr, 3), invalid (n, P, nr) bool."""
    code = model_conf["code"]
    xy, z, dist, inv_f = project(points, f_w2c, f_k)
    coord = code_coord(z if model_conf.get("code_mode", "z") == "z"
                       else dist, model_conf)
    x = torch.cat([sample_map(feats, xy),
                   posenc(prec.code_input(torch.cat([xy, coord[..., None]],
                                                    -1)),
                          code["num_freqs"], code["freq_factor"],
                          code.get("include_input", True))], -1)
    sigma = mlp(p, x, model_conf, prec)[..., 0]
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


def patch_loss(rgb, rgb_gt, weights, invalid, depth, lambda_eas: float):
    """The reconstruction loss of patch rays.
    rgb (n, pc, p, p, nr, 3); rgb_gt (n, pc, p, p, 3); weights (n, pc, p,
    p, K); invalid (n, pc, p, p, K, nr) bool; depth (n, pc, p, p).
    Per view 0.85 SSIM + 0.15 L1, the minimum over the render views,
    rays whose weight sits over 90% on invalid samples in every view
    left out (as zero), the mean counted twice (the coarse and the
    fine branch, the fine one a copy), plus edge-aware smoothness.
    Returns (the loss, {"loss_rgb": the photometric mean, "loss_eas": the
    smoothness mean})."""
    n, pc, ph, pw, nr, c = rgb.shape
    a = rgb.permute(0, 1, 4, 5, 2, 3).reshape(-1, c, ph, pw)
    b = rgb_gt[:, :, None].expand(n, pc, nr, ph, pw, c) \
        .permute(0, 1, 2, 5, 3, 4).reshape(-1, c, ph, pw)
    err = 0.85 * ssim_error(a, b).mean(1) + 0.15 * (a - b).abs().mean(1)
    err = err.reshape(n, pc, nr, ph, pw).amin(2)
    mass = (invalid.to(weights.dtype) * weights[..., None]).sum(-2)
    invalid_ray = (mass > 0.9).all(-1)
    rgb_loss = (err * (1.0 - invalid_ray.to(err.dtype))).mean()
    disp = 1.0 / torch.clamp(depth, 1e-3, 80.0)
    disp = disp / disp.mean(dim=(-2, -1), keepdim=True)
    d_dx = (disp[..., :, :-1] - disp[..., :, 1:]).abs() * torch.exp(
        -(rgb_gt[..., :, :-1, :] - rgb_gt[..., :, 1:, :]).abs().mean(-1))
    d_dy = (disp[..., :-1, :] - disp[..., 1:, :]).abs() * torch.exp(
        -(rgb_gt[..., :-1, :, :] - rgb_gt[..., 1:, :, :]).abs().mean(-1))
    eas = (F.pad(d_dx, (0, 1)) + F.pad(d_dy, (0, 0, 0, 1))) \
        * (1.0 - invalid_ray.to(err.dtype))
    eas = eas.mean()
    return 2.0 * rgb_loss + lambda_eas * eas, {"loss_rgb": rgb_loss,
                                               "loss_eas": eas}


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
    the loss views, "z_jitter" (n, R, K) in [0, 1)."""
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
    s = torch.arange(k, dtype=dt, device=dev) / k + draws["z_jitter"] / k
    if rc.get("lindisp", True):
        z = 1.0 / (1.0 / near * (1.0 - s) + 1.0 / far * s)
    else:
        z = near * (1.0 - s) + far * s                   # (n, R, K)
    pts = origins[:, :, None] + z[..., None] * dirs[:, :, None]
    r = pts.shape[1]
    sigma, rgbs, invalid = query(
        p, feats, pts.reshape(n, r * k, 3), w2c[:, 0], projs[:, 0],
        colors01[:, ir].permute(0, 1, 4, 2, 3), w2c[:, ir], projs[:, ir],
        mc, prec)
    nr = len(ids["render"])
    weights = composite_weights(sigma.reshape(n, r, k), z,
                                rc.get("hard_alpha_cap", False))
    rgb = (weights[..., None, None] * rgbs.reshape(n, r, k, nr, 3)).sum(2)
    depth = (weights * z).sum(-1)
    pc = r // (ps * ps)
    shp = (n, pc, ps, ps)
    return patch_loss(rgb.reshape(shp + (nr, 3)), rgb_gt,
                      weights.reshape(shp + (k,)),
                      invalid.reshape(shp + (k, nr)), depth.reshape(shp),
                      conf["loss"].get("lambda_edge_aware_smoothness", 0.0))


def selfview_depth(p, image, proj, conf: dict, prec: Precision,
                   rows: int = 8192):
    """z-depth (h, w) of one frame through its own camera: image (h, w, 3)
    in [-1, 1], proj (3, 3). BatchNorm on running statistics; every pixel's
    ray sampled on one camera-z ladder at the bin midpoints, density from
    the pixel's feature and the code of (x, y, z), composited over each
    ray's distances; computed in blocks of `rows` pixels."""
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
        sigma = mlp(p, x, mc, prec)[..., 0]
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
