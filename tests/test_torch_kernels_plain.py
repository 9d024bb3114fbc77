"""Plain PyTorch versions of the port's three CUDA kernels against the
JAX package's formulations on the same numpy inputs, and the wrappers'
CPU dispatch. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.

Tolerances are those of the JAX package's own kernel tests:
shared_z 1e-5 (tests/test_pallas_shared_z.py:36), jitter_density
2e-2 abs/rel for bf16 (tests/test_pallas_jitter.py), selfview 3e-5
(tests/test_pallas_selfview.py:31). The kernels' weight layouts and
arithmetic orders are checked here too, written out in PyTorch from the
same Python functions that build the layouts for the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.ops.pallas.jitter_density import (
    interleave_to_grouped as j_perm, jitter_density_jnp)
from behindthescenes_tpu.ops.pallas.selfview import selfview_density_fused
from behindthescenes_tpu.ops.pallas.shared_z import shared_z_tail_jnp
from behindthescenes_tpu_torch.ops import kernels
from behindthescenes_tpu_torch.ops.kernels import _build
from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
    check_shapes as jitter_check_shapes
from behindthescenes_tpu_torch.ops.kernels.jitter_density import (
    jitter_density, jitter_density_plain, mma_code_columns,
    pack_code_weights)
from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
    kernel_for as jitter_kernel_for
from behindthescenes_tpu_torch.ops.kernels.selfview import \
    check_shapes as selfview_check_shapes
from behindthescenes_tpu_torch.ops.kernels.selfview import (
    grouped_code_weights, interleave_to_grouped, selfview_density,
    selfview_density_plain, softplus)
from behindthescenes_tpu_torch.ops.kernels.shared_z import \
    kernel_for as shared_z_kernel_for
from behindthescenes_tpu_torch.ops.kernels.shared_z import (
    shared_z_tail, shared_z_tail_plain)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

N_FREQS, FREQ_FACTOR = 6, 1.5


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("shape", [(500, 24, 64), (128, 64, 32),
                                   (33, 7, 16)])
def test_shared_z_plain_matches_jnp(shape):
    b, k, h = shape
    rng = np.random.default_rng(0)
    hs = rng.normal(size=(b, h)).astype(np.float32)
    hd = rng.normal(size=(k, h)).astype(np.float32)
    w = rng.normal(size=(h, 1)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32)
    want = shared_z_tail_jnp(jnp.asarray(hs), jnp.asarray(hd),
                             jnp.asarray(w), jnp.asarray(bias))
    got = shared_z_tail_plain(_t(hs), _t(hd), _t(w), _t(bias))
    assert got.shape == (b, k, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", [(500, 24, 64), (128, 64, 32),
                                   (33, 7, 16)])
def test_shared_z_plain_matches_jnp_bf16(shape):
    """bf16 hs and hd (the JAX package's default evaluation dtype): both
    add them in bf16 before the relu and project in f32, so they agree to
    the f32 tolerance."""
    b, k, h = shape
    rng = np.random.default_rng(5)
    hs = rng.normal(0, 2, (b, h)).astype(np.float32)
    hd = rng.normal(0, 2, (k, h)).astype(np.float32)
    w = _t(rng.normal(size=(h, 1)).astype(np.float32)).bfloat16()
    bias = rng.normal(size=(1,)).astype(np.float32)
    j16 = [jnp.asarray(x, jnp.bfloat16) for x in (hs, hd)]
    want = shared_z_tail_jnp(*j16, jnp.asarray(w.float().numpy(),
                                               jnp.bfloat16),
                             jnp.asarray(bias))
    got = shared_z_tail_plain(_t(hs).bfloat16(), _t(hd).bfloat16(), w,
                              _t(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # Adding in f32 instead is a different function, at bf16 size.
    f32_add = shared_z_tail_plain(_t(hs).bfloat16().float(),
                                  _t(hd).bfloat16().float(), w, _t(bias))
    assert np.abs(f32_add.numpy() - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_shared_z_plain_matches_jnp_multi_column(dtype):
    """w_out (H, 4), the tail of a d_out 4 model (`sample_color: false`):
    the sum and the relu in the inputs' dtype, the contraction and b_out
    in f32, as shared_z_tail_jnp, within 1e-5."""
    b, k, h, d = 200, 24, 32, 4
    rng = np.random.default_rng(9)
    hs = rng.normal(0, 2, (b, h)).astype(np.float32)
    hd = rng.normal(0, 2, (k, h)).astype(np.float32)
    w = rng.normal(size=(h, d)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = shared_z_tail_jnp(*(jnp.asarray(x, jdt) for x in (hs, hd, w)),
                             jnp.asarray(bias))
    got = shared_z_tail_plain(*(_t(x).to(dtype) for x in (hs, hd, w)),
                              _t(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, k, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _shared_z_inputs(b, k, h, seed):
    """hs, hd, w_out (H, 1), b_out at the flagship's magnitudes (outputs
    up to ~40)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (b, h)).astype(np.float32),
            rng.normal(0, 2, (k, h)).astype(np.float32),
            rng.normal(0, 1, (h, 1)).astype(np.float32),
            rng.normal(size=(1,)).astype(np.float32))


@pytest.mark.parametrize("h", [32, 64])
def test_shared_z_register_tile_order_matches_jnp(h):
    """The f32 kernel's arithmetic written out in PyTorch: each output
    keeps four partial sums over j mod 4, each a chain over increasing j of
    w_j * relu(hs + hd), added pairwise, then + b_out. It is
    shared_z_tail_jnp's function within 1e-5."""
    b, k = 96, 44
    hs, hd, w, bias = _shared_z_inputs(b, k, h, seed=10)
    terms = torch.relu(_t(hs)[:, None, :] + _t(hd)[None]) * _t(w)[:, 0]
    acc = torch.zeros(b, k, 4)
    for jc in range(h // 4):                   # j = 4 jc + q
        acc = acc + terms[..., 4 * jc:4 * jc + 4]
    out = ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])) \
        + _t(bias)
    want = shared_z_tail_jnp(*(jnp.asarray(x) for x in (hs, hd, w, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want)[..., 0],
                               atol=1e-5)


def _mma_hidden_units(h):
    """The bf16 kernel's hidden units per m16n8k16 chunk c and fragment
    column: lane t of a quad holds columns 2t, 2t+1 (units t*H/4 + 4c,
    +1) and 2t+8, 2t+9 (units t*H/4 + 4c + 2, +3)."""
    units = np.zeros((h // 16, 16), np.int64)
    for c in range(h // 16):
        for t in range(4):
            j = t * (h // 4) + 4 * c
            units[c, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = \
                [j, j + 1, j + 2, j + 3]
    return units


@pytest.mark.parametrize("h", [32, 64])
def test_shared_z_tensor_core_formulation_matches_jnp(h):
    """The bf16 kernel's arithmetic written out in fragment order: each
    chunk's A tile is relu(bf16(hs + hd)) over its 16 units in column
    order, its B column the bf16 w over the same units; the chunk's
    products (exact in f32) sum into its own f32 accumulator and the
    chunks add pairwise, then + b_out. The chunks cover every unit once,
    and the result is shared_z_tail_jnp's on the bf16 inputs within
    1e-5."""
    b, k = 96, 44
    units = _mma_hidden_units(h)
    assert sorted(units.ravel().tolist()) == list(range(h))
    hs, hd, w, bias = _shared_z_inputs(b, k, h, seed=11)
    bf = torch.bfloat16
    hs16, hd16, w16 = (_t(x).to(bf) for x in (hs, hd, w))
    x = torch.relu(hs16[:, None, :] + hd16[None])           # bf16
    part = [x[..., _t(u)].float() @ w16[_t(u)].float() for u in units]
    acc = part[0] + part[1]
    if len(part) == 4:
        acc = acc + (part[2] + part[3])
    out = acc + _t(bias)
    want = shared_z_tail_jnp(*(jnp.asarray(v.float().numpy(), jnp.bfloat16)
                               for v in (hs16, hd16, w16)),
                             jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("h,kernel", [(32, "built"), (64, "built"),
                                      (48, "any"), (16, "any"),
                                      (128, "any")])
def test_shared_z_kernel_for_width(h, kernel):
    """The wrapper picks the built f32/bf16 kernels for H = 32 and 64 and
    the runtime-H kernel for any other width, before any launch."""
    assert shared_z_kernel_for(h) == kernel


def _jitter_inputs(b, k, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, k)).astype(np.float32),
            rng.normal(0, 0.5, (b, h)).astype(np.float32),
            rng.normal(0, 0.3, (13, h)).astype(np.float32),
            rng.normal(0, 0.1, (h,)).astype(np.float32),
            rng.normal(0, 0.3, (h,)).astype(np.float32),
            np.array([0.07], np.float32))


@pytest.mark.parametrize("shape", [(640, 16, 64), (500, 8, 64),
                                   (96, 64, 32)])
def test_jitter_density_plain_matches_jnp(shape):
    coord, hs, wd, b_in, w_out, b_out = _jitter_inputs(*shape, seed=1)
    want = jitter_density_jnp(
        jnp.asarray(coord), jnp.asarray(hs), jnp.asarray(wd),
        jnp.asarray(b_in), jnp.asarray(w_out[:, None]), b_out[0],
        n_freqs=N_FREQS, freq_factor=FREQ_FACTOR)
    got = jitter_density_plain(_t(coord), _t(hs), _t(wd), _t(b_in),
                               _t(w_out), _t(b_out), n_freqs=N_FREQS,
                               freq_factor=FREQ_FACTOR)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("shape,n_freqs", [((96, 30, 48), 6),
                                           ((64, 20, 40), 4),
                                           ((50, 17, 64), 8)])
def test_jitter_density_plain_matches_jnp_runtime_shapes(shape, n_freqs):
    """The shapes the runtime-shape kernel serves on the card (H not 32 or
    64, other octave counts, ragged K): the plain version it is held to
    there is jitter_density_jnp's function, at the kernel's tolerance."""
    b, k, h = shape
    rng = np.random.default_rng(12)
    coord = rng.uniform(-1, 1, (b, k)).astype(np.float32)
    hs = rng.normal(0, 0.5, (b, h)).astype(np.float32)
    wd = rng.normal(0, 0.3, (1 + 2 * n_freqs, h)).astype(np.float32)
    b_in = rng.normal(0, 0.1, (h,)).astype(np.float32)
    w_out = rng.normal(0, 0.3, (h,)).astype(np.float32)
    b_out = np.array([0.07], np.float32)
    want = jitter_density_jnp(
        jnp.asarray(coord), jnp.asarray(hs), jnp.asarray(wd),
        jnp.asarray(b_in), jnp.asarray(w_out[:, None]), b_out[0],
        n_freqs=n_freqs, freq_factor=FREQ_FACTOR)
    got = jitter_density_plain(_t(coord), _t(hs), _t(wd), _t(b_in),
                               _t(w_out), _t(b_out), n_freqs=n_freqs,
                               freq_factor=FREQ_FACTOR)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("h,n_freqs,kernel", [
    (64, 6, "mma"), (32, 6, "mma"), (48, 6, "any"), (64, 4, "any"),
    (100, 16, "any"), (64, 17, None), (64, 0, None)])
def test_jitter_kernel_for_shapes(h, n_freqs, kernel):
    """The wrapper picks the tensor-core kernel for its built shapes and
    the runtime-shape kernel for any other H and 1 to 16 octaves; more
    octaves than that raise before any launch."""
    if kernel is None:
        with pytest.raises(ValueError):
            jitter_kernel_for(h, n_freqs)
    else:
        assert jitter_kernel_for(h, n_freqs) == kernel


@pytest.mark.parametrize("shape", [(256, 32, 64), (64, 64, 64),
                                   (96, 24, 32)])
def test_selfview_plain_matches_pallas_interpret(shape):
    hw, k, h = shape
    rng = np.random.default_rng(2)
    h_static = rng.standard_normal((hw, h)).astype(np.float32)
    coord = rng.uniform(-1, 1, (hw, k)).astype(np.float32)
    w_z = (rng.standard_normal((13, h)) * 0.2).astype(np.float32)
    b_in = (rng.standard_normal(h) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal(h) * 0.2).astype(np.float32)
    want = selfview_density_fused(
        jnp.asarray(h_static), jnp.asarray(coord), jnp.asarray(w_z),
        jnp.asarray(b_in), jnp.asarray(w_out), 0.05, k_samples=k,
        interpret=True)
    got = selfview_density_plain(_t(h_static), _t(coord), _t(w_z),
                                 _t(b_in), _t(w_out),
                                 torch.tensor([0.05]), n_freqs=N_FREQS,
                                 freq_factor=FREQ_FACTOR)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_selfview_equals_jitter_math_in_f32():
    """The selfview kernel is the jitter decode's function at f32 with
    softplus, with W_z in the grouped code order."""
    coord, hs, wd, b_in, w_out, b_out = _jitter_inputs(64, 16, 32, seed=3)
    # Interleaved-order f32 reference written out from the formula.
    c = _t(coord).double()
    freqs = FREQ_FACTOR * 2.0 ** torch.arange(N_FREQS, dtype=torch.float64)
    sc = c[..., None] * freqs
    code = torch.cat([c[..., None], torch.stack(
        [torch.sin(sc), torch.cos(sc)], -1).reshape(64, 16, 12)], -1)
    hid = torch.relu(code @ _t(wd).double() + _t(hs).double()[:, None]
                     + _t(b_in).double())
    want = softplus(hid @ _t(w_out).double() + float(b_out[0]))
    perm = torch.as_tensor(interleave_to_grouped(N_FREQS))
    got = selfview_density_plain(_t(hs), _t(coord), _t(wd)[perm], _t(b_in),
                                 _t(w_out), _t(b_out), n_freqs=N_FREQS,
                                 freq_factor=FREQ_FACTOR)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


def _interleaved_code(coord):
    """The 13-dim z code in the PositionalEncoding (interleaved) order."""
    freqs = FREQ_FACTOR * 2.0 ** torch.arange(N_FREQS, dtype=coord.dtype)
    sc = coord[..., None] * freqs
    return torch.cat([coord[..., None], torch.stack(
        [torch.sin(sc), torch.cos(sc)], -1).flatten(-2)], -1)


def test_mma_code_layout_gives_the_interleaved_product():
    """The jitter kernel's 16 code columns times the packed W_d equal the
    interleaved code times W_d; every code row appears once and the three
    pad columns and rows are zero."""
    cols = mma_code_columns()
    assert sorted(cols[cols >= 0].tolist()) == list(range(13))
    assert (cols < 0).sum() == 3
    coord, _, wd, *_ = _jitter_inputs(40, 16, 64, seed=6)
    code = _interleaved_code(_t(coord))                       # (B, K, 13)
    code16 = torch.where(_t(cols) >= 0, code[..., _t(cols).clamp_min(0)],
                         torch.zeros(()))                     # kernel order
    packed = pack_code_weights(_t(wd))
    assert packed.shape == (16, 64) and packed.is_contiguous()
    assert (packed[_t(cols) < 0] == 0).all()
    assert (code16[..., _t(cols) < 0] == 0).all()
    np.testing.assert_allclose((code16 @ packed).numpy(),
                               (code @ _t(wd)).numpy(), atol=1e-5)


def test_jitter_tensor_core_formulation_matches_plain():
    """The kernel's arithmetic written out in PyTorch: the code in the
    mma column order rounded to bf16, the product with the packed W_d
    summed in f32 and rounded, + h_static and + b_in each rounded in
    bf16, relu, the projection summed in f32 and rounded, + b_out. It is
    jitter_density_plain up to the order of the f32 sums (atol/rtol
    2e-2, the kernel's tolerance)."""
    coord, hs, wd, b_in, w_out, b_out = _jitter_inputs(256, 32, 64, seed=7)
    cols = _t(mma_code_columns())
    code = _interleaved_code(_t(coord))
    code16 = torch.where(cols >= 0, code[..., cols.clamp_min(0)],
                         torch.zeros(())).bfloat16()
    bf = torch.bfloat16
    packed = pack_code_weights(_t(wd).to(bf))
    hd = (code16.float() @ packed.float()).to(bf)
    x = torch.relu(_t(hs).to(bf)[:, None, :] + hd + _t(b_in).to(bf))
    out = (x.float() @ _t(w_out).to(bf).float()).to(bf).float() \
        + _t(b_out)
    want = jitter_density_plain(_t(coord), _t(hs), _t(wd), _t(b_in),
                                _t(w_out), _t(b_out), n_freqs=N_FREQS,
                                freq_factor=FREQ_FACTOR)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)


def test_selfview_register_tiled_order_matches_plain():
    """The selfview kernel's arithmetic written out in PyTorch on its
    W_z layout (grouped_code_weights): each hidden unit starts at
    h_static + b_in and adds the 13 code products in order; the
    projection keeps four partial sums over j mod 4, added pairwise; then
    softplus. It gives back selfview_density_plain within 3e-5."""
    coord, hs, wd, b_in, w_out, b_out = _jitter_inputs(96, 16, 64, seed=8)
    wz = grouped_code_weights(_t(wd), N_FREQS)
    np.testing.assert_array_equal(
        wz.numpy(), wd[interleave_to_grouped(N_FREQS)])
    c = _t(coord)
    freqs = FREQ_FACTOR * 2.0 ** torch.arange(N_FREQS, dtype=torch.float32)
    sc = c[..., None] * freqs
    code = torch.cat([c[..., None], torch.sin(sc), torch.cos(sc)], -1)
    h = (_t(hs) + _t(b_in))[:, None, :].expand(96, 16, 64)
    for i in range(13):
        h = h + code[..., i:i + 1] * wz[i]
    terms = torch.relu(h) * _t(w_out)                          # (B, K, 64)
    acc = terms.reshape(96, 16, 16, 4).sum(2)                  # j mod 4
    out = softplus((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
                   + _t(b_out))
    want = selfview_density_plain(_t(hs), c, wz, _t(b_in), _t(w_out),
                                  _t(b_out), n_freqs=N_FREQS,
                                  freq_factor=FREQ_FACTOR)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=3e-5)


JIT, SV = jitter_check_shapes, selfview_check_shapes


@pytest.mark.parametrize("check,k,h,n_freqs,ok", [
    (JIT, 64, 64, 6, True),
    (JIT, 48, 64, 6, True),
    (JIT, 40, 64, 6, True),             # a last partial tile of 16
    (JIT, 24, 32, 6, True),             # exp_synthetic's K and H
    (JIT, 64, 48, 6, False),            # H not 32 or 64
    (JIT, 64, 64, 4, False),            # other octave count
    (SV, 64, 64, 6, True),
    (SV, 44, 64, 6, True),
    (SV, 32, 32, 6, True),              # exp_synthetic_thin's K and H
    (SV, 46, 64, 6, False),             # K not a multiple of 4
    (SV, 64, 128, 6, False),            # H not 32 or 64
    (SV, 64, 64, 8, False),
], ids=lambda v: getattr(v, "__module__", "").rsplit(".", 1)[-1] or None)
def test_kernel_shape_checks(check, k, h, n_freqs, ok):
    """What each redesigned kernel takes is checked in Python before any
    build or launch; what it does not take raises."""
    if ok:
        check(k, h, n_freqs)
    else:
        with pytest.raises(ValueError):
            check(k, h, n_freqs)


def test_parse_ptxas_report():
    text = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 412 bytes "
        "cmem[0]\n"
        "ptxas info    : Function properties for __internal_trig_reduce\n"
        "    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3barv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 8 registers, 360 bytes cmem[0]\n")
    assert _build.parse_ptxas(text) == {
        "_Z3fooPf": {"registers": 96, "stack": 16, "spill_stores": 8,
                     "spill_loads": 4},
        "_Z3barv": {"registers": 8, "stack": 0, "spill_stores": 0,
                    "spill_loads": 0}}


def test_interleave_perm_matches_jax():
    for f in (1, 3, 6):
        np.testing.assert_array_equal(interleave_to_grouped(f), j_perm(f))


def test_softplus_matches_jax_formula():
    x = torch.linspace(-60, 60, 1001)
    want = np.logaddexp(x.double().numpy(), 0.0)
    np.testing.assert_allclose(softplus(x).numpy(), want, rtol=1e-6,
                               atol=1e-7)


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    coord, hs, wd, b_in, w_out, b_out = _jitter_inputs(40, 8, 16, seed=4)
    kernels.reset_launch_counts()
    w_col = _t(w_out)[:, None]
    np.testing.assert_array_equal(
        shared_z_tail(_t(hs), _t(wd), w_col, _t(b_out)).numpy(),
        shared_z_tail_plain(_t(hs), _t(wd), w_col, _t(b_out)).numpy())
    kw = dict(n_freqs=N_FREQS, freq_factor=FREQ_FACTOR)
    np.testing.assert_array_equal(
        jitter_density(_t(coord), _t(hs), _t(wd), _t(b_in), _t(w_out),
                       _t(b_out), **kw).numpy(),
        jitter_density_plain(_t(coord), _t(hs), _t(wd), _t(b_in),
                             _t(w_out), _t(b_out), **kw).numpy())
    np.testing.assert_array_equal(
        selfview_density(_t(hs), _t(coord), _t(wd), _t(b_in), _t(w_out),
                         _t(b_out), **kw).numpy(),
        selfview_density_plain(_t(hs), _t(coord), _t(wd), _t(b_in),
                               _t(w_out), _t(b_out), **kw).numpy())
    assert kernels.launch_counts() == {"shared_z": 0, "jitter_density": 0,
                                       "selfview": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Off the GPU machine the build fails loudly, before making any
    directory, and the sources it would compile are all there."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", ())
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build").exists()
    names = sorted(p.rsplit("/", 1)[-1] for p in _build.sources())
    assert names == ["common.cuh", "jitter_density.cu", "selfview.cu",
                     "shared_z.cu"]
    assert len(_build.source_hash()) == 16
