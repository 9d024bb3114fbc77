"""The work counts that the FLOP and roofline metrics divide by."""
import pytest
import torch

from port_bench import flops
from port_bench.calibrate import cell_conf
from port_bench.reference.model import encode
from port_bench.reference.precision import Precision
from port_bench.weights import make_weights


class CountingPrecision(Precision):
    """float32 products that count each convolution's FLOPs from the
    shapes it actually sees."""

    def __init__(self):
        super().__init__("float32")
        self.flops = 0

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        out = super().conv2d(x, w, b, stride, padding)
        n, cout, ho, wo = out.shape
        self.flops += 2 * w.shape[1] * cout * w.shape[2] * w.shape[3] \
            * ho * wo * n
        return out


@pytest.mark.parametrize("config", ["kitti360", "re10k"])
@pytest.mark.parametrize("hw", [(64, 96), (96, 160)])
def test_encoder_flops_match_counted_convolutions(config, hw):
    conf, _ = cell_conf(config + ".train")
    mc = conf["model_conf"]
    counter = CountingPrecision()
    with torch.no_grad():
        encode(make_weights(mc, 1, "cpu"), torch.zeros(1, 3, *hw), mc, False,
               counter)
    assert flops.encoder_flops(mc, *hw) == counter.flops


def test_shared_z_work_is_the_kernel_tables():
    b, k, h = 122_880, 64, 64
    nbytes, ops = flops.shared_z_work(b, k, h, bf16=True)
    assert nbytes / 1e6 == pytest.approx(47.2, abs=0.05)
    assert flops.bound_seconds(nbytes, ops) * 1e3 == pytest.approx(
        0.0141, abs=5e-5)
    nbytes32, ops32 = flops.shared_z_work(b, k, h, bf16=False)
    assert sum(ops32.values()) / 1e9 == pytest.approx(2.01, abs=0.005)
    assert flops.bound_seconds(nbytes32, ops32) * 1e3 == pytest.approx(
        0.0300, abs=5e-5)


def test_step_flops_count_backward_twice():
    conf, _ = cell_conf("kitti360.train")
    mc = conf["model_conf"]
    fwd = 4 * flops.encoder_flops(mc, 192, 640) \
        + 4 * 4096 * 64 * flops.mlp_flops_per_sample(mc)
    assert flops.train_step_flops(conf) == 3 * fwd
    assert flops.mlp_flops_per_sample(mc) == 2 * (103 * 64 + 64)
