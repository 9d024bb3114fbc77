"""Work counted from shapes: the model's FLOPs as the published model
defines them, a kernel's operations and bytes, and the card's peaks.

Model FLOPs: every convolution 2 Cin Cout k^2 Hout Wout, every dense
layer of the field MLP 2 d_in d_out on every sample (the positional
code, the sampling and the composite are not counted); a backward pass
counts twice its forward. A kernel's work is what its inputs need, each
input read once and each output written once, so the count is the same
whatever implements it.
"""
from __future__ import annotations

from port_bench.reference.model import (RESNET, fine_mlp, is_spatial,
                                        mlp_widths)

# Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet and
# the H100 architecture white paper; dense rates).
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_VEC_FLOP_S = 133.8e12
BF16_FLOP_S = 989e12


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def _conv(cin, cout, k, h, w) -> int:
    return 2 * cin * cout * k * k * h * w


def encoder_flops(model_conf: dict, h: int, w: int) -> int:
    """Forward FLOPs of the encoder over one h x w image: the ResNet
    trunk, then monodepth2's decoder; the spatial encoder's trunk only up
    to its last map used (pixelNeRF runs no later stage) and no decoder
    (the resize of its maps is not counted)."""
    enc = model_conf["encoder"]
    kind, counts, ch_enc = RESNET[enc["resnet_layers"]]
    spatial = is_spatial(model_conf)
    if spatial:
        counts = counts[:enc["num_layers"] - 1]
    hh, ww = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    total = _conv(3, 64, 7, hh, ww)
    sizes = [(hh, ww)]
    hh, ww = _out(hh, 3, 2, 1), _out(ww, 3, 2, 1)
    inplanes = 64
    for stage, (n, width) in enumerate(zip(counts, (64, 128, 256, 512))):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            ho, wo = _out(hh, 3, stride, 1), _out(ww, 3, stride, 1)
            if kind == "bottleneck":
                out = width * 4
                total += (_conv(inplanes, width, 1, hh, ww)
                          + _conv(width, width, 3, ho, wo)
                          + _conv(width, out, 1, ho, wo))
            else:
                out = width
                total += (_conv(inplanes, width, 3, ho, wo)
                          + _conv(width, width, 3, ho, wo))
            if stride != 1 or inplanes != out:
                total += _conv(inplanes, out, 1, ho, wo)
            inplanes, hh, ww = out, ho, wo
        sizes.append((hh, ww))
    if spatial:
        return total
    d_out = enc["d_out"]
    ch = [max(d_out, c) for c in enc["num_ch_dec"]]
    c_cur = ch_enc[-1]
    for i in range(4, -1, -1):
        total += _conv(c_cur, ch[i], 3, hh, ww)
        hh, ww = 2 * hh, 2 * ww
        c_in = ch[i]
        if i > 0:
            hh, ww = min(hh, sizes[i - 1][0]), min(ww, sizes[i - 1][1])
            c_in += ch_enc[i - 1]
        total += _conv(c_in, ch[i], 3, hh, ww)
        c_cur = ch[i]
    return total + _conv(ch[0], d_out, 3, hh, ww)


def mlp_flops_per_sample(model_conf: dict, name: str = "mlp_coarse") -> int:
    """Forward FLOPs of the field MLP `name` on one sample's concatenated
    input (the latent and the code)."""
    d_in, hid, d_out, blocks = mlp_widths(model_conf, name)
    return 2 * (d_in * hid + hid * d_out + blocks * 2 * hid * hid)


def train_step_flops(conf: dict) -> int:
    """Model FLOPs of one training micro-step: the encoder over each item's
    encoder view, the coarse MLP over every coarse sample and, with a
    fine pass, the fine pass's MLP over every coarse and fine sample,
    forward and backward (three forwards)."""
    mc, rc = conf["model_conf"], conf["renderer"]
    h, w = conf["data"]["image_size"]
    n = conf["batch_size"]
    rays = n * mc["ray_batch_size"]
    total = (n * encoder_flops(mc, h, w)
             + rays * rc["n_coarse"] * mlp_flops_per_sample(mc))
    if rc.get("n_fine", 0) > 0:
        total += rays * (rc["n_coarse"] + rc["n_fine"]) \
            * mlp_flops_per_sample(mc, fine_mlp(mc))
    return 3 * total


def depth_frame_flops(conf: dict) -> int:
    """Model FLOPs of one depth frame: the encoder, then the MLP on every
    pixel's n_coarse samples."""
    mc = conf["model_conf"]
    h, w = conf["data"]["image_size"]
    return (encoder_flops(mc, h, w)
            + h * w * conf["renderer"]["n_coarse"] * mlp_flops_per_sample(mc))


def shared_z_work(b: int, k: int, h: int, bf16: bool):
    """(bytes, {peak FLOP/s: FLOP}) of one shared_z tail call on hs (B, H),
    hd (K, H), w_out (H, 1), b_out (1,) -> out (B, K, 1) f32: 4 B K H
    operations (the add, the relu and the projection's multiply-add).
    In bf16 the add and relu run on the CUDA cores and the projection's
    products on the tensor cores; in f32 all on the CUDA cores."""
    elem = 2 if bf16 else 4
    nbytes = elem * (b * h + k * h + h) + 4 * (1 + b * k)
    if not bf16:
        return nbytes, {F32_FLOP_S: 4 * b * k * h}
    return nbytes, {BF16_VEC_FLOP_S: 2 * b * k * h, BF16_FLOP_S: 2 * b * k * h}


def bound_seconds(nbytes: int, ops: dict) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory's bandwidth and the operations, each at its own peak."""
    return max(nbytes / HBM_BYTES_S, sum(f / p for p, f in ops.items()))
