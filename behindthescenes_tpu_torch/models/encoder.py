"""Image encoder emitting pixel-aligned feature maps (counterpart of
behindthescenes_tpu/models/encoder.py:25-256, 348).

ResNet-18/34/50 with the monodepth2 U-Net decoder. Module and parameter
names follow the reference's torch modules (torchvision's ResNet inside
`ResnetEncoder.encoder`, the decoder's `nn.ModuleList` of conv blocks), so
the port's state_dict keys are the reference checkpoints' keys. Tensors
are NCHW inside; `compute_dtype=torch.bfloat16` runs the convolutions in
bf16 while BatchNorm and the activations between blocks stay f32, as the
JAX package does.

BatchNorm is the port's own (`BatchNorm2d`) with Flax's semantics in train
mode; `EncoderDummy` is the learned constant map of the overfit harness.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """`conv` with input and weights cast to the compute dtype. Below f32
    the convolution is rounded before the bias is added, as Flax's Conv
    adds it (a fused bias rounds once)."""
    if dtype not in (torch.bfloat16, torch.float16) or conv.bias is None:
        if x.dtype == dtype == conv.weight.dtype:
            return conv(x)
        bias = None if conv.bias is None else conv.bias.to(dtype)
        return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias,
                        conv.stride, conv.padding)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding) + conv.bias.to(dtype)[:, None, None]


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's semantics (nn.BatchNorm(momentum=0.9,
    epsilon=1e-5), behindthescenes_tpu/models/encoder.py:39-40, 113-114),
    keeping torch's state-dict names. Eval mode normalises with the
    running statistics. Train mode normalises with the batch mean and the
    BIASED batch variance, and moves the running statistics 10% toward
    them, the variance biased too (torch's own BatchNorm2d moves it toward
    the unbiased variance)."""

    FLAX_MOMENTUM = 0.9

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # Flax's statistics: the mean, and the variance as E[x^2] - E[x]^2
        # (its use_fast_variance), which the gradient flows through.
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            m = self.FLAX_MOMENTUM
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


def _bn(bn: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in its parameters' dtype (f32 after bf16 convolutions)."""
    return bn(x.to(bn.weight.dtype))


class BasicBlock(nn.Module):
    """ResNet-18/34 block."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.dt = compute_dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes))

    def forward(self, x):
        out = torch.relu(_bn(self.bn1, _conv(self.conv1, x, self.dt)))
        out = _bn(self.bn2, _conv(self.conv2, out, self.dt))
        identity = x if self.downsample is None else _bn(
            self.downsample[1], _conv(self.downsample[0], x, self.dt))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """ResNet-50 block (expansion 4, stride on the 3x3 conv)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.dt = compute_dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                BatchNorm2d(planes * 4))

    def forward(self, x):
        out = torch.relu(_bn(self.bn1, _conv(self.conv1, x, self.dt)))
        out = torch.relu(_bn(self.bn2, _conv(self.conv2, out, self.dt)))
        out = _bn(self.bn3, _conv(self.conv3, out, self.dt))
        identity = x if self.downsample is None else _bn(
            self.downsample[1], _conv(self.downsample[0], x, self.dt))
        return torch.relu(out + identity)


_RESNET_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2), (64, 64, 128, 256, 512)),
    34: (BasicBlock, (3, 4, 6, 3), (64, 64, 128, 256, 512)),
    50: (Bottleneck, (3, 4, 6, 3), (64, 256, 512, 1024, 2048)),
}


class ResNet(nn.Module):
    """torchvision's ResNet trunk (no pooling head): conv1, bn1, layer1-4."""

    def __init__(self, num_layers: int, compute_dtype=torch.float32):
        super().__init__()
        block, counts, _ = _RESNET_SPECS[num_layers]
        self.dt = compute_dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (n, width) in enumerate(zip(counts, (64, 128, 256, 512))):
            blocks = []
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(block(inplanes, width, stride, compute_dtype))
                inplanes = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """5-level ResNet feature pyramid (reference monodepth2.py:71-107).
    Input in [0, 1], NCHW; returns features at strides 2, 4, 8, 16, 32."""

    def __init__(self, num_layers: int = 18, compute_dtype=torch.float32):
        super().__init__()
        self.num_ch_enc = _RESNET_SPECS[num_layers][2]
        self.encoder = ResNet(num_layers, compute_dtype)

    def forward(self, x):
        r = self.encoder
        x = (x - 0.45) / 0.225
        feats = [torch.relu(_bn(r.bn1, _conv(r.conv1, x, r.dt)))]
        x = F.max_pool2d(feats[-1], 3, 2, 1)
        for stage in range(1, 5):
            x = getattr(r, f"layer{stage}")(x)
            feats.append(x)
        return feats


def reflect_pad1(x):
    """Reflect padding by one pixel of an NCHW map, as `jnp.pad(...,
    mode="reflect")`: a dimension of size 1 pads with its edge (reflecting
    one pixel gives itself), which `F.pad(mode="reflect")` refuses."""
    if x.shape[-1] > 1 and x.shape[-2] > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    for pad, size in (((1, 1, 0, 0), x.shape[-1]),
                      ((0, 0, 1, 1), x.shape[-2])):
        x = F.pad(x, pad, mode="reflect" if size > 1 else "replicate")
    return x


class Conv3x3(nn.Module):
    """Reflect-padded 3x3 conv (reference layers.py Conv3x3)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3)

    def forward(self, x, dtype=torch.float32):
        return _conv(self.conv, reflect_pad1(x), dtype)


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (reference layers.py ConvBlock)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv3x3(in_ch, out_ch)

    def forward(self, x, dtype=torch.float32):
        return F.elu(self.conv(x, dtype))


class Decoder(nn.Module):
    """U-Net decoder emitting multi-scale latents (reference
    monodepth2.py:172-239). `decoder` is the reference's ModuleList:
    [upconv_4_0, upconv_4_1, ..., upconv_0_0, upconv_0_1] then one
    dispconv per scale."""

    def __init__(self, num_ch_enc, num_ch_dec=(128, 128, 256, 256, 512),
                 d_out: int = 128, scales=(0, 1, 2, 3), use_skips=True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        self.dt = compute_dtype
        ch = [max(d_out, c) for c in num_ch_dec]
        convs = []
        for i in range(4, -1, -1):
            c_in = num_ch_enc[-1] if i == 4 else ch[i + 1]
            convs.append(ConvBlock(c_in, ch[i]))
            c_in = ch[i] + (num_ch_enc[i - 1] if use_skips and i > 0 else 0)
            convs.append(ConvBlock(c_in, ch[i]))
        for s in self.scales:
            convs.append(Conv3x3(ch[s], d_out))
        self.decoder = nn.ModuleList(convs)

    def forward(self, input_features):
        outputs = {}
        x = input_features[-1]
        for n, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * n](x, self.dt)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if self.use_skips and i > 0:
                feats = input_features[i - 1]
                x = x[:, :, :feats.shape[2], :feats.shape[3]]
                x = torch.cat([x.to(feats.dtype), feats], dim=1)
            x = self.decoder[2 * n + 1](x, self.dt)
            if i in self.scales:
                outputs[i] = self.decoder[10 + self.scales.index(i)](
                    x, self.dt)
        return outputs


class Monodepth2(nn.Module):
    """ResNet encoder + U-Net decoder (reference monodepth2.py:242-302).
    Input images in [-1, 1], NCHW; returns per-scale f32 latents."""

    def __init__(self, resnet_layers: int = 18, num_ch_dec=None,
                 d_out: int = 128, scales=(0, 1, 2, 3), freeze: bool = False,
                 compute_dtype=torch.float32):
        super().__init__()
        self.latent_size = d_out
        self.scales = tuple(scales)
        self.freeze = freeze
        self.encoder = ResnetEncoder(resnet_layers, compute_dtype)
        self.decoder = Decoder(
            self.encoder.num_ch_enc,
            tuple(num_ch_dec) if num_ch_dec is not None
            else (128, 128, 256, 256, 512), d_out, self.scales,
            compute_dtype=compute_dtype)

    def forward(self, x):
        outputs = self.decoder(self.encoder(x * 0.5 + 0.5))
        latents = [outputs[i].to(torch.promote_types(outputs[i].dtype,
                                                     torch.float32))
                   for i in self.scales]
        if self.freeze:
            # The gradient stops at the backbone's output, as in the JAX
            # package (its BatchNorm statistics still move in train mode).
            latents = [lat.detach() for lat in latents]
        return latents


class EncoderDummy(nn.Module):
    """Learned constant feature map in place of the CNN, the overfit
    harness (behindthescenes_tpu/models/encoder.py:316-335). Returns the
    map (n, d_out, h, w) for every image."""

    def __init__(self, size=(48, 160), d_out: int = 64):
        super().__init__()
        self.latent_size = d_out
        self.scales = (0,)
        self.feats = nn.Parameter(torch.randn(size[0], size[1], d_out))

    def forward(self, x):
        return [self.feats.permute(2, 0, 1)[None].expand(
            x.shape[0], -1, -1, -1)]


_BACKBONE_KEYS = {
    "monodepth2": {"type", "remat", "resnet_layers", "num_ch_dec", "d_out",
                   "scales", "pretrained", "pretrained_strict", "freeze",
                   "cp_location"},
    "dummy": {"type", "size", "d_out"},
}


def make_backbone(conf: dict, compute_dtype=torch.float32):
    """Backbone factory: the monodepth2 and dummy types. remat, pretrained
    and cp_location are accepted and not used here: the trainer refuses
    the ImageNet initialisation they ask for (the synthetic configs set
    none of them)."""
    btype = conf.get("type", "monodepth2")
    if btype not in _BACKBONE_KEYS:
        raise NotImplementedError(f"encoder type {btype!r} is not ported")
    unknown = set(conf) - _BACKBONE_KEYS[btype]
    if unknown:
        raise ValueError(f"unknown encoder config keys: {sorted(unknown)}")
    if btype == "dummy":
        return EncoderDummy(tuple(conf.get("size", (48, 160))),
                            conf.get("d_out", 64))
    return Monodepth2(resnet_layers=conf.get("resnet_layers", 18),
                      num_ch_dec=conf.get("num_ch_dec", None),
                      d_out=conf.get("d_out", 128),
                      scales=tuple(conf.get("scales", (0, 1, 2, 3))),
                      freeze=conf.get("freeze", False),
                      compute_dtype=compute_dtype)
