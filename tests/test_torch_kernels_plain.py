"""Plain PyTorch versions of the port's three CUDA kernels against the
JAX package's formulations on the same numpy inputs, and the wrappers'
CPU dispatch. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.

Tolerances are those of the JAX package's own kernel tests:
shared_z 1e-5 (tests/test_pallas_shared_z.py:36), jitter_density
2e-2 abs/rel for bf16 (tests/test_pallas_jitter.py), selfview 3e-5
(tests/test_pallas_selfview.py:31).
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
from behindthescenes_tpu_torch.ops.kernels.jitter_density import (
    interleave_to_grouped, jitter_density, jitter_density_plain)
from behindthescenes_tpu_torch.ops.kernels.selfview import (
    selfview_density, selfview_density_plain, softplus)
from behindthescenes_tpu_torch.ops.kernels.shared_z import (
    shared_z_tail, shared_z_tail_plain)

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
                             jnp.asarray(w), jnp.asarray(bias))[..., 0]
    got = shared_z_tail_plain(_t(hs), _t(hd), _t(w[:, 0]), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


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
    np.testing.assert_array_equal(
        shared_z_tail(_t(hs), _t(wd), _t(w_out), _t(b_out)).numpy(),
        shared_z_tail_plain(_t(hs), _t(wd), _t(w_out), _t(b_out)).numpy())
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
