"""The port's train step against the JAX package's on the same batch, the
same initial parameters (carried across by the weight bridge) and the same
random choices (the test replays the JAX step's key splits and hands the
draws to the port): loss terms, gradients, BatchNorm statistics and the
Adam update, in f32 and bf16, with the JAX step evaluated in float64 as
the exact reference; the port's overfit harness and eval step; and
the weight bridge both ways, down to a checkpoint of the port's train.py
that the JAX package loads.
"""
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from behindthescenes_tpu.datasets.synthetic import \
    SyntheticBoxDataset as JDataset
from behindthescenes_tpu.models import encoder as jencoder
from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import train as train_cli
from behindthescenes_tpu_torch.datasets.synthetic import (SyntheticBoxDataset,
                                                          collate)
from behindthescenes_tpu_torch.ray_sampler import PatchDraws
from behindthescenes_tpu_torch.training.trainer import (BTSTrainer,
                                                        make_optimizer)
from behindthescenes_tpu_torch.training.wrapper import Draws
from behindthescenes_tpu_torch.weights import (flat_from_state_dict,
                                               load_params_npz,
                                               state_dict_from_flat)

FLAGSHIP = os.path.join(os.path.dirname(__file__), "..", "media", "weights",
                        "flagship_fast_conv.npz")
LOSS = {"criterion": "l1+ssim", "invalid_policy": "weight_guided",
        "lambda_edge_aware_smoothness": 0.001}


def _config(encoder, d_hidden, n_freqs, patch, rays, n_coarse, lr=1e-4):
    return {
        "seed": 0, "learning_rate": lr, "scheduler": {"type": "fix"},
        "model_conf": {
            "arch": "BTSNet", "z_near": 1.0, "z_far": 40.0, "inv_z": True,
            "code_mode": "z", "learn_empty": False, "encoder": encoder,
            "code": {"num_freqs": n_freqs, "freq_factor": 1.5,
                     "include_input": True},
            "mlp_coarse": {"type": "resnet", "n_blocks": 0,
                           "d_hidden": d_hidden},
            "mlp_fine": {"type": "empty"}, "n_frames_render": 2,
            "frame_sample_mode": "default", "sample_mode": "patch",
            "patch_size": patch, "ray_batch_size": rays,
            "prediction_mode": "default", "flip_augmentation": False},
        "loss": LOSS,
        "renderer": {"n_coarse": n_coarse, "n_fine": 0, "lindisp": True,
                     "hard_alpha_cap": True},
    }


# configs/exp_synthetic.yaml's model (ResNet-18, 16-channel latents,
# ResnetFC width 32) at 32x48, 4 items, 64 rays of 8 samples.
RESNET = dict(shape=(4, 32, 48), conf=_config(
    {"type": "monodepth2", "resnet_layers": 18,
     "num_ch_dec": [16, 16, 32, 32, 64], "d_out": 16, "scales": [0]},
    32, 6, 4, 64, 8))
# The overfit harness's model (tests/test_train_overfit.py:14-50).
DUMMY = dict(shape=(1, 24, 32), conf=_config(
    {"type": "dummy", "size": (24, 32), "d_out": 16}, 32, 4, 4, 128, 16,
    lr=5e-3))


def _batch(shape):
    n, h, w = shape
    ds = JDataset(length=n, frame_count=4, height=h, width=w,
                  return_depth=False, seed=1)
    return collate([ds[i] for i in range(n)])


def _flat(tree, prefix, dtype=np.float32):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(p, "key", p)) for p in kp)] = \
            np.asarray(leaf, dtype)
    return out


def _jax_init(trainer, batch, key):
    """JAX's initial variables as BTSTrainer.init_state makes them
    (training/trainer.py:113-127: the net's initializer on stand-ins of
    the batch's shapes), with the initializer jitted: run eagerly it
    takes about 40 s of the CPU for the ResNet."""
    images = jnp.zeros(batch["imgs"].shape, jnp.float32)
    poses = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                             batch["poses"].shape)
    projs = jnp.broadcast_to(
        jnp.asarray([[0.6, 0, 0], [0, 1.8, 0], [0, 0, 1]],
                    dtype=jnp.float32), batch["projs"].shape)
    xyz = jnp.zeros((batch["imgs"].shape[0], 8, 3))
    return jax.jit(trainer.net.init)(key, images, projs, poses, xyz)


def replay_draws(key, n, v_loss, h, w, patch, rays, n_coarse) -> Draws:
    """The draws of the JAX step with `key`: wrapper.forward splits it into
    k_flip, k_rays, k_render; the patch sampler splits k_rays per item and
    then into views, rows and columns; render_rays splits k_render five
    ways and the coarse sampler draws uniform from the first."""
    _, k_rays, k_render = jax.random.split(key, 3)
    pc = rays // (patch * patch)
    cols = []
    for kk in jax.random.split(k_rays, n):
        kv, ky, kx = jax.random.split(kk, 3)
        cols.append([jax.random.randint(kv, (pc,), 0, v_loss),
                     jax.random.randint(ky, (pc,), 0, h - patch),
                     jax.random.randint(kx, (pc,), 0, w - patch)])
    views, ys, xs = (torch.as_tensor(np.stack([np.asarray(c[i])
                                               for c in cols])).long()
                     for i in range(3))
    jitter = jax.random.uniform(jax.random.split(k_render, 5)[0],
                                (n, rays, n_coarse), dtype=jnp.float32)
    return Draws(rays=PatchDraws(views, ys, xs),
                 z_jitter=torch.as_tensor(np.array(jitter)))


class JaxStep:
    """One JAX train step's pieces: initial variables, view ids, the jitted
    gradient of the loss (with the loss terms and new BatchNorm statistics)
    and the draws replayed from its key."""

    def __init__(self, spec, dtype=jnp.float32, key=7):
        self.conf = spec["conf"]
        self.shape = spec["shape"]
        self.batch = _batch(self.shape)
        self.trainer = JTrainer(self.conf, mesh=make_mesh(jax.devices()[:1]),
                                compute_dtype=dtype)
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        variables = _jax_init(self.trainer, self.batch,
                              jax.random.PRNGKey(0))
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats", {})
        self.opt_state = self.trainer.tx.init(self.params)
        self.flat0 = {**_flat(self.params, "params/"),
                      **_flat(self.batch_stats, "batch_stats/")}
        self.ids = self.trainer.wrapper.select_views(
            np.random.default_rng(self.conf["seed"]), 4, training=True)
        self.key = jax.random.PRNGKey(key)
        wrapper, criterion = self.trainer.wrapper, self.trainer.criterion

        def loss_fn(params, batch_stats):
            variables = {"params": params}
            if batch_stats:
                variables["batch_stats"] = batch_stats
            data, new_vars = wrapper.forward(variables, jbatch, self.key,
                                             self.ids, train=True)
            loss, terms = criterion(data)
            return loss, (terms, new_vars.get("batch_stats", {}))
        self.grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
        grads, (terms, new_bs) = self.grad_fn(self.params, self.batch_stats)
        self.grads = _flat(grads, "params/")
        self.terms = {k: float(v) for k, v in terms.items()}
        self.new_stats = _flat(new_bs, "batch_stats/")
        self.grads_tree = grads
        n, h, w = self.shape
        mc = self.conf["model_conf"]
        self.draws = replay_draws(self.key, n, len(self.ids.ids_loss), h, w,
                                  mc["patch_size"], mc["ray_batch_size"],
                                  self.conf["renderer"]["n_coarse"])

    def loss_at(self, flat):
        """JAX's loss terms at other variables (same shapes: the jitted
        function is reused)."""
        params = {k: v for k, v in flat.items() if k.startswith("params/")}
        stats = {k: v for k, v in flat.items()
                 if k.startswith("batch_stats/")}

        def nest(d):
            tree = {}
            for key, arr in d.items():
                node = tree
                parts = key.split("/")[1:]
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(arr)
            return tree
        _, (terms, _) = self.grad_fn(nest(params), nest(stats))
        return {k: float(v) for k, v in terms.items()}


class _Float64Layers:
    """flax.linen as the JAX encoder module sees it, with its convolutions
    and BatchNorm computing in float64 (the module pins them to the
    compute dtype and to f32, models/encoder.py:34-40)."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def Conv(*args, **kw):
        return flax.linen.Conv(*args, **{**kw, "dtype": jnp.float64})

    @staticmethod
    def BatchNorm(*args, **kw):
        return flax.linen.BatchNorm(*args, **{**kw, "dtype": jnp.float64})


def jax_float64_step(step: JaxStep):
    """The exact reference of `step`: the JAX package's same step (its
    variables, batch, views and key) evaluated in float64 under
    jax.enable_x64, through the f32 model's general path, with the
    encoder's convolutions and BatchNorm switched to float64 and the patch
    and jitter draws made at the 32-bit width of the f32 step (x64 widens
    randint's and uniform's defaults, which draws other values). Returns
    float64 gradients, loss terms and BatchNorm statistics by Flax key."""
    trainer = JTrainer(step.conf, mesh=make_mesh(jax.devices()[:1]),
                       compute_dtype=jnp.float32)
    randint, uniform = jax.random.randint, jax.random.uniform

    def randint32(key, shape, minval, maxval, dtype=None):
        return randint(key, shape, minval, maxval, jnp.int32)

    def uniform32(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return uniform(key, shape, jnp.float32, minval, maxval).astype(
            dtype or jnp.float64)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jencoder, "nn", _Float64Layers())
        mp.setattr(jax.random, "randint", randint32)
        mp.setattr(jax.random, "uniform", uniform32)
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)
        batch = {k: jnp.asarray(np.asarray(v, np.float64))
                 for k, v in step.batch.items()}

        def loss_fn(params, batch_stats):
            data, new_vars = trainer.wrapper.forward(
                {"params": params, "batch_stats": batch_stats}, batch,
                step.key, step.ids, train=True)
            loss, terms = trainer.criterion(data)
            return loss, (terms, new_vars.get("batch_stats", {}))
        grads, (terms, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            f64(step.params), f64(step.batch_stats))
        assert all(g.dtype == jnp.float64
                   for g in jax.tree_util.tree_leaves(grads))
        return (_flat(grads, "params/", np.float64),
                {k: float(v) for k, v in terms.items()},
                _flat(stats, "batch_stats/", np.float64))


def port_step(step: JaxStep, dtype, flat=None, draws=None, batch=None):
    """The port's trainer on the same config and ids, from `flat` (default:
    JAX's initial variables), one train step with the replayed draws.
    Returns (trainer, loss terms)."""
    trainer = BTSTrainer(step.conf, compute_dtype=dtype, device="cpu")
    trainer.net.load_state_dict(state_dict_from_flat(flat or step.flat0))
    if dtype == torch.float64:
        trainer.net.double()
    trainer.optimizer, trainer.lr_schedule = make_optimizer(
        step.conf, trainer.net.parameters())
    batch = batch or step.batch
    draws = draws or step.draws
    if dtype == torch.float64:
        batch = {k: torch.as_tensor(v).double() for k, v in batch.items()}
        draws = Draws(rays=draws.rays, z_jitter=draws.z_jitter.double())
    terms = trainer.train_step(batch, draws)
    return trainer, {k: float(v) for k, v in terms.items()}


def _grads(trainer):
    return flat_from_state_dict({n: p.grad for n, p in
                                 trainer.net.named_parameters()})


def _cos(a, b):
    return float((a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b),
                                     1e-30))


@pytest.fixture(scope="module")
def resnet_step():
    return JaxStep(RESNET)


@pytest.fixture(scope="module")
def dummy_step():
    return JaxStep(DUMMY)


@pytest.mark.parametrize("which", ["resnet18", "dummy"])
def test_f32_step_matches_jax(which, request):
    """f32, JAX's initial parameters and draws, against JAX's f32 step and
    against its float64 evaluation (jax_float64_step), the exact reference.

    The loss and every loss term within 1e-5 relative of JAX's f32, the
    BatchNorm running statistics after the step within 1e-5. Every
    gradient tensor within 1e-4 x max|g| of JAX's float64 step (measured
    1.4e-5 for the ResNet, 6.9e-6 for the learned map), and the port's
    own float64 step within 1e-5 x max|g| of it (measured 4.6e-7: JAX's
    float64 evaluation keeps a few f32 roundings, such as the encoder's
    input cast to the compute dtype, models/encoder.py:108), its loss
    terms within 1e-7 relative (measured 1.7e-9).

    Against JAX's f32 gradients: the learned map's (no BatchNorm) within
    1e-4 x max|g|. The ResNet's cannot be: with BatchNorm in train mode
    JAX's f32 gradients on the CPU are up to 0.108 x max|g| from its own
    float64 step, because Flax takes the batch variance as E[x^2] - E[x]^2
    and XLA's f32 reductions of those two terms cancel (measured: with
    Flax's two-pass variance, 6.7e-5). The port uses the same formula
    but torch's reductions, which land within 1.4e-5. So each ResNet
    tensor is held to JAX's f32 within 1e-4 x max|g| plus JAX's own
    distance from its float64 step, and to a cosine similarity of 0.999;
    and the port must be the nearer of the two to exact, in gradients and
    in loss."""
    step = request.getfixturevalue(
        {"resnet18": "resnet_step", "dummy": "dummy_step"}[which])
    trainer, terms = port_step(step, torch.float32)
    assert set(terms) == set(step.terms)
    for k, want in step.terms.items():
        np.testing.assert_allclose(terms[k], want, rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    exact, exact_terms, exact_stats = jax_float64_step(step)
    port64, port64_terms = port_step(step, torch.float64)
    for k, want in exact_terms.items():
        np.testing.assert_allclose(port64_terms[k], want, rtol=1e-7,
                                   atol=1e-12, err_msg=k)
    got, got64 = _grads(trainer), _grads(port64)
    assert set(got) == set(step.grads) == set(exact)
    port_err = jax_err = 0.0
    for k, g in step.grads.items():
        scale = np.abs(exact[k]).max()
        if scale == 0:
            assert not got[k].any(), k
            continue
        port_gap = np.abs(got[k] - exact[k]).max()
        jax_gap = np.abs(g - exact[k]).max()
        port_err = max(port_err, port_gap / scale)
        jax_err = max(jax_err, jax_gap / scale)
        assert np.abs(got64[k] - exact[k]).max() <= 1e-5 * scale, k
        assert port_gap <= 1e-4 * scale, k
        if which == "dummy":
            assert np.abs(got[k] - g).max() <= 1e-4 * np.abs(g).max(), k
        else:
            assert np.abs(got[k] - g).max() <= 1e-4 * scale + jax_gap, k
            assert _cos(got[k], g) >= 0.999, k
    assert port_err <= jax_err, (port_err, jax_err)
    loss_err = abs(terms["loss"] - exact_terms["loss"])
    assert loss_err <= abs(step.terms["loss"] - exact_terms["loss"])
    stats = flat_from_state_dict(trainer.net.state_dict())
    stats64 = flat_from_state_dict(port64.net.state_dict())
    for k, want in step.new_stats.items():
        np.testing.assert_allclose(stats[k], want, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(stats64[k], exact_stats[k], atol=1e-6,
                                   err_msg=k)
    assert set(step.new_stats) == set(exact_stats)
    if which == "resnet18":
        assert step.new_stats


def test_adam_matches_optax(resnet_step):
    """The port's Adam fed JAX's gradients lands on optax's parameters
    within 1e-7, or one f32 ulp of the parameter where that is larger
    (torch's Adam divides by its bias corrections in another order than
    optax; measured: one BatchNorm scale near 1.0 one ulp apart)."""
    step = resnet_step
    updates, _ = jax.jit(step.trainer.tx.update)(
        step.grads_tree, step.opt_state, step.params)
    want = _flat(optax.apply_updates(step.params, updates), "params/")
    trainer = BTSTrainer(step.conf, compute_dtype=torch.float32,
                         device="cpu")
    trainer.net.load_state_dict(state_dict_from_flat(step.flat0))
    opt, _ = make_optimizer(step.conf, trainer.net.parameters())
    grads = state_dict_from_flat(step.grads)
    for name, p in trainer.net.named_parameters():
        p.grad = grads[name].clone()
    opt.step()
    got = flat_from_state_dict(dict(trainer.net.named_parameters()))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-7, rtol=2.0 ** -23,
                                   err_msg=k)


def test_bf16_step_matches_jax():
    """bf16 compute (the JAX trainer's default), at 64x96 on 2 items,
    against JAX's bf16 step and its float64 evaluation (jax_float64_step).
    The loss within 1e-2 relative of JAX's (measured 7.1e-5). Each
    gradient tensor's cosine similarity with JAX's at least 0.99 outside
    the ResNet trunk (measured 0.9990 at worst).

    In the trunk, BatchNorm in train mode over few pixels amplifies bf16
    rounding: JAX's own bf16 gradients sit down to a cosine of 0.964 from
    its float64 step (measured), so 0.99 against JAX is beyond JAX itself.
    There each tensor is held to a cosine of 0.95 against JAX (measured
    0.966), and the float64 step is the witness: each trunk tensor's
    cosine with it at most 0.02 below JAX's own (measured 0.0099), the
    whole trunk's at most 0.005 below (measured 0.0004; 0.9872 against
    JAX's 0.9876). JAX on the CPU keeps bf16 convolution outputs
    unrounded; the port rounds them, as the card's bf16 convolutions do."""
    spec = dict(RESNET, shape=(2, 64, 96))
    step = JaxStep(spec, dtype=jnp.bfloat16)
    trainer, terms = port_step(step, torch.bfloat16)
    np.testing.assert_allclose(terms["loss"], step.terms["loss"], rtol=1e-2)
    exact, _, _ = jax_float64_step(step)
    got = _grads(trainer)
    trunk = [k for k in step.grads if k.startswith("params/encoder/encoder/")]
    for k, g in step.grads.items():
        if not np.abs(g).max() > 0:
            continue
        if k not in trunk:
            assert _cos(got[k], g) >= 0.99, (k, _cos(got[k], g))
            continue
        assert _cos(got[k], g) >= 0.95, (k, _cos(got[k], g))
        ours, theirs = _cos(got[k], exact[k]), _cos(g, exact[k])
        assert ours >= theirs - 0.02, (k, ours, theirs)
    cat = [np.concatenate([d[k].ravel() for k in trunk])
           for d in (got, step.grads, exact)]
    assert _cos(cat[0], cat[1]) >= 0.98, _cos(cat[0], cat[1])
    assert _cos(cat[0], cat[2]) >= _cos(cat[1], cat[2]) - 0.005


def _overfit_batch(h=24, w=32, frames=4):
    ds = SyntheticBoxDataset(length=1, frame_count=frames, height=h, width=w)
    return collate([ds[0]])


def test_overfit_loss_decreases():
    """The port's counterpart of tests/test_train_overfit.py:53-77: the
    learned map in place of the CNN, 120 steps on one batch, bf16 (the
    trainer's default); the mean of the last 10 losses below 0.85 x the
    mean of the first 10."""
    batch = _overfit_batch()
    del batch["depths"]
    trainer = BTSTrainer(DUMMY["conf"], device="cpu")
    trainer.init_state()
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(120)]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert np.isfinite(losses).all(), losses
    assert last < first * 0.85, (first, last)


def test_eval_step_depth_metrics():
    """The eval step renders every view in chunks with the running
    statistics and returns the seven depth metrics, finite."""
    trainer = BTSTrainer(DUMMY["conf"], device="cpu")
    trainer.init_state()
    out = trainer.eval_step(_overfit_batch(frames=2))
    assert out["depth"].shape == (1, 2, 24, 32)
    m = {k: float(v) for k, v in out["metrics"].items()}
    assert set(m) == {"abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2",
                      "a3"}
    assert np.isfinite(list(m.values())).all()


def test_weight_bridge_round_trip():
    """Flax keys -> the port's state_dict -> Flax keys: the flagship
    artifact comes back exactly, key for key."""
    flat = load_params_npz(FLAGSHIP)
    back = flat_from_state_dict(state_dict_from_flat(flat), (0,))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v.astype(np.float32))


def test_train_cli_checkpoint_loads_in_jax(resnet_step, tmp_path):
    """`train.py --config exp_synthetic --device cpu --steps 2` writes a
    checkpoint that the JAX package's load_params_npz reads; at those
    parameters JAX's loss on the step's batch equals the port's within
    1e-5 relative."""
    losses = train_cli.main(["--steps", "2", "--config", "exp_synthetic",
                             "--device", "cpu", "--f32", "--out",
                             str(tmp_path)])
    assert len(losses) == 2 and np.isfinite(losses).all()
    path = os.path.join(tmp_path, "params.npz")
    variables = j_load_npz(path)
    flat = {**_flat(variables["params"], "params/"),
            **_flat(variables["batch_stats"], "batch_stats/")}
    assert set(flat) == set(resnet_step.flat0)
    want = resnet_step.loss_at(flat)
    _, got = port_step(resnet_step, torch.float32,
                       flat=load_params_npz(path))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert not np.allclose(flat["params/mlp_coarse/lin_in/kernel"],
                           resnet_step.flat0[
                               "params/mlp_coarse/lin_in/kernel"])


def test_train_configs_mirror_the_yaml():
    """train.py reads configs/exp_synthetic*.yaml through the port's
    config loader: the whole composed config equals the JAX config
    loader's, overrides included; the precision is bf16 unless --f32."""
    from behindthescenes_tpu.config import load_config
    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    for name in ("exp_synthetic_flagship", "exp_synthetic"):
        want = load_config(os.path.join(root, name + ".yaml"),
                           {"renderer": {"n_coarse": 16}})
        got = train_cli.config(name, overrides=["renderer.n_coarse=16"])
        assert got.pop("bf16") and not train_cli.config(name, True)["bf16"]
        assert got == want, name
