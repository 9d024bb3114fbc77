"""chip_smoke.py's bookkeeping, checked on the CPU: the work it divides by
the card's peaks to get each kernel's bound, the ragged cuts it checks the
redesigned kernels on, and the tables that name each kernel's record.
(The script itself needs the card; its contract is checked there.)"""
import importlib.util
import os

import pytest
import torch

from behindthescenes_tpu.ops.pallas.jitter_density import kernel_cost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

B, K, H = 96, 64, 64
KW = dict(n_freqs=6, freq_factor=1.5)


def _decode_args(name, dtype, b=B):
    coord = torch.zeros(b, K)
    h_static = torch.zeros(b, H, dtype=dtype)
    rest = (torch.zeros(13, H), torch.zeros(H), torch.zeros(H),
            torch.zeros(1))
    if name == "selfview":
        return (h_static, coord) + rest
    return (coord, h_static) + rest


@pytest.mark.parametrize("name,dtype,weight_bytes", [
    ("selfview", torch.float32, 4 * (15 * H + 1)),
    ("jitter_density", torch.bfloat16, 2 * 15 * H + 4),
])
def test_decode_work_is_the_jax_kernel_cost(name, dtype, weight_bytes):
    """FLOP are the JAX package's `kernel_cost`, each term at the peak of
    its type; bytes are its count (bf16 h_static) or the f32 one, plus the
    small weights read once."""
    nbytes, flops = cs.work(name, _decode_args(name, dtype), KW)
    want_flop, want_bytes = kernel_cost(B, K, H, 6)
    assert sum(flops.values()) == want_flop
    if name == "selfview":
        want_bytes += 2 * B * H          # h_static in f32, not bf16
        assert set(flops) == {cs.F32_FLOP_S}
    else:                                # products, add + relu, code
        assert flops == {cs.BF16_FLOP_S: B * K * (2 * 13 * H + 2 * H),
                         cs.BF16_VEC_FLOP_S: B * K * 2 * H,
                         cs.F32_FLOP_S: B * K * 2 * 13}
    assert nbytes == want_bytes + weight_bytes


def test_shared_z_work_counts_bf16_inputs_at_two_bytes():
    """bf16 inputs: half the bytes of hs and hd; the add and the relu run
    at the bf16 peak of the CUDA cores, the projection's multiply-add at
    the f32 one."""
    args32 = (torch.zeros(B, H), torch.zeros(K, H), torch.zeros(H),
              torch.zeros(1))
    args16 = (args32[0].bfloat16(), args32[1].bfloat16()) + args32[2:]
    b32, f32 = cs.work("shared_z", args32, {})
    b16, f16 = cs.work("shared_z_bf16", args16, {})
    assert b32 - b16 == 2 * (B * H + K * H)
    assert f32 == {cs.F32_FLOP_S: 4 * B * K * H}
    assert f16 == {cs.BF16_VEC_FLOP_S: 2 * B * K * H,
                   cs.F32_FLOP_S: 2 * B * K * H}


@pytest.mark.parametrize("h,k", cs.RAGGED_HK)
@pytest.mark.parametrize("name", ["selfview", "jitter_density"])
def test_ragged_cut_keeps_the_weights(name, h, k):
    """The cut leaves a partial block of rays and a partial tile of 16
    samples, and keeps the first h hidden units of every weight."""
    assert cs.RAGGED_B % 4 and k % 16 and k % 4 == 0
    args = _decode_args(name, torch.float32, b=2 * cs.RAGGED_B)
    args = tuple(a + torch.arange(a.shape[-1]) for a in args)
    cut = cs.ragged(name, args, h, k)
    coord, h_static = (cut[1], cut[0]) if name == "selfview" \
        else (cut[0], cut[1])
    assert tuple(coord.shape) == (cs.RAGGED_B, k)
    assert tuple(h_static.shape) == (cs.RAGGED_B, h)
    assert all(a.is_contiguous() for a in cut)
    for a, b in zip(cut[2:5], args[2:5]):
        assert torch.equal(a, b[..., :h])
        assert (a is b) == (h == H)
    assert cut[5] is args[5]


def test_every_record_is_named_everywhere():
    """Each serving mode's record has a tolerance, a source, the TPU kernel
    it replaces (a file:line that defines a function) and a ptxas name."""
    records = {rec for *_, rec in cs.MODES}
    assert records == set(cs.TOLERANCE) == set(cs.KERNEL_META) \
        == set(cs.PTXAS_NAME)
    for source, replaces in cs.KERNEL_META.values():
        assert os.path.exists(os.path.join(ROOT, source))
        path, line = replaces.rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith("def ")
