"""The port's data-parallel train step against its 1-rank step and the JAX
package's 1-device step (counterpart of tests/test_multidevice_equiv.py:
32x48, a global batch of 8, ResNet-18, f32).

Two ranks over gloo (`parallel.launch.run_ranks`) each take 4 items of
the global batch; the weights are JAX's initial variables, carried across
by the weight bridge. With the JAX step's draws replayed (each rank its
rows) the 2-rank gradient must equal the 1-rank gradient and JAX's
1-device gradient; with the trainers' own generator (each rank draws the
global batch's values and takes its rows) the 2-rank step must equal the
1-rank step. A sliced batch, a missing reduction, per-rank BatchNorm
statistics or rank-seeded draws all fail these bounds by orders of
magnitude.

Against JAX the gradient is held with one more allowance: its own
sensitivity. At this batch the gradient of the first block of layer3 is
ill-conditioned: scaling the images by 1 + 1e-7 (one f32 rounding) moves
the port's own float64 gradient of `layer3_0/conv2` by 0.3046 x the
leaf's max, and the port's and JAX's float64 steps (the same loss to
1.6e-11) sit 0.3046 x apart in that leaf, 3e-5 x elsewhere at a batch of
4. So each element may also differ from JAX's by what a one-ulp scaling
of the images moves the port's own f32 gradient there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu_torch.parallel.launch import run_ranks
from tests.test_multidevice_equiv import _tiny_config
from tests.test_torch_train import _flat, _jax_init, replay_draws
from tests.torch_dist_ranks import (make_trainer, micro_steps_rank,
                                    np_batch, step_result, train_steps_rank)

# One intra-op thread: pytest-xdist runs several workers on this CPU.
torch.set_num_threads(1)

H, W, N = 32, 48, 8
WORLD = 2
SPAWN_TIMEOUT = 180.0


def _leaf_close(a: dict, b: dict, what: str, rtol=1e-3, atol_of_max=1e-2):
    """tests/test_multidevice_equiv.py's `_allclose_tree`: per leaf, an
    absolute floor of 1e-2 x the leaf's own max."""
    assert set(a) == set(b), what
    for k in a:
        atol = max(1e-9, atol_of_max * float(np.abs(a[k]).max()
                                             if a[k].size else 0.0))
        np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def setup():
    conf = _tiny_config()
    batch = np_batch(H, W, N)
    trainer = JTrainer(conf, mesh=make_mesh(jax.devices()[:1]))
    variables = _jax_init(trainer, batch, jax.random.PRNGKey(0))
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    flat0 = {**_flat(params, "params/"), **_flat(stats, "batch_stats/")}
    ids = trainer.wrapper.select_views(np.random.default_rng(conf["seed"]),
                                       3, training=True)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        data, _ = trainer.wrapper.forward({"params": p, "batch_stats": stats},
                                          jbatch, key, ids, train=True)
        loss, _ = trainer.criterion(data)
        return loss
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = trainer.tx.update(grads, trainer.tx.init(params), params)
    import optax
    new_params = optax.apply_updates(params, updates)
    mc = conf["model_conf"]
    draws = replay_draws(key, N, len(ids.ids_loss), H, W, mc["patch_size"],
                         mc["ray_batch_size"], conf["renderer"]["n_coarse"])
    jax_ref = {"loss": float(loss), "grads": _flat(grads, "params/"),
               "params": _flat(new_params, "params/")}
    one = {"replayed": step_result(make_trainer(conf, flat0), batch, draws),
           "generated": step_result(make_trainer(conf, flat0), batch)}
    nudged = dict(batch, imgs=batch["imgs"] * np.float32(1 + 2 ** -23))
    one["nudged"] = step_result(make_trainer(conf, flat0), nudged, draws)
    ranks = run_ranks(train_steps_rank, WORLD,
                      (conf, flat0, batch, draws), timeout=SPAWN_TIMEOUT)
    return conf, jax_ref, one, ranks, flat0, batch


@pytest.mark.parametrize("draws", ["replayed", "generated"])
def test_grads_match_across_rank_counts(setup, draws):
    """The 2-rank loss within 1e-6 relative of the 1-rank loss and its
    gradient within rtol 1e-3, atol 1e-2 x each leaf's max (the JAX
    test's bounds)."""
    _, _, one, ranks, *_ = setup
    want = one[draws]
    for r, res in enumerate(ranks):
        got = res[draws]
        loss1, loss2 = want["terms"]["loss"], got["terms"]["loss"]
        assert abs(loss2 - loss1) <= 1e-6 * max(1.0, abs(loss1)), (r, draws)
        _leaf_close(want["grads"], got["grads"], f"rank {r} vs 1 rank")


def test_grads_match_jax_one_device(setup):
    """With JAX's draws, the 1-rank and 2-rank losses within 1e-6 relative
    of JAX's 1-device loss, and every gradient element within rtol 1e-3,
    atol 1e-2 x its leaf's max of JAX's 1-device gradient, plus the
    port's own movement there under a one-ulp scaling of the images
    (module docstring)."""
    _, jax_ref, one, ranks, *_ = setup
    base, nudged = one["replayed"]["grads"], one["nudged"]["grads"]
    sides = [("1 rank", one["replayed"])] + [
        (f"rank {r}", res["replayed"]) for r, res in enumerate(ranks)]
    for name, side in sides:
        assert abs(side["terms"]["loss"] - jax_ref["loss"]) \
            <= 1e-6 * max(1.0, abs(jax_ref["loss"])), name
        assert set(side["grads"]) == set(jax_ref["grads"]), name
        for k, want in jax_ref["grads"].items():
            bound = 1e-3 * np.abs(want) + 1e-2 * np.abs(want).max() \
                + np.abs(nudged[k] - base[k])
            np.testing.assert_array_less(
                np.abs(side["grads"][k] - want), bound + 1e-12,
                err_msg=f"{name} vs JAX: {k}")


@pytest.mark.parametrize("draws", ["replayed", "generated"])
def test_train_step_params_match_across_rank_counts(setup, draws):
    """The full step (gradient and Adam): every parameter of the 2-rank
    step within 3 lr of the 1-rank step's (and, with JAX's draws, of JAX's
    step's), and under 5e-3 of the elements apart by more than 0.5 lr
    (Adam's first update is about lr x sign(g), ill-conditioned where g
    sits at reduction noise; tests/test_multidevice_equiv.py:130-150)."""
    conf, jax_ref, one, ranks, *_ = setup
    lr = conf["learning_rate"]
    refs = {"1 rank": {k: v for k, v in one[draws]["state"].items()
                       if k.startswith("params/")}}
    if draws == "replayed":
        refs["JAX"] = jax_ref["params"]
    for r, res in enumerate(ranks):
        got = res[draws]["state"]
        for name, ref in refs.items():
            total = moved = 0
            worst = 0.0
            for k, v in ref.items():
                diff = np.abs(got[k] - v)
                total += diff.size
                moved += int((diff > 0.5 * lr).sum())
                worst = max(worst, float(diff.max()))
            assert worst < 3 * lr, (r, name, worst)
            assert moved / total < 5e-3, (r, name, moved, total)


@pytest.mark.parametrize("draws", ["replayed", "generated"])
def test_batchnorm_statistics_match_across_rank_counts(setup, draws):
    """The running statistics after the step: the global batch's on every
    rank, within 1e-6 of the 1-rank step's."""
    _, _, one, ranks, *_ = setup
    want = {k: v for k, v in one[draws]["state"].items()
            if k.startswith("batch_stats/")}
    assert want
    for res in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(res[draws]["state"][k], v, rtol=0,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("draws", ["replayed", "generated"])
def test_parameters_identical_on_every_rank(setup, draws):
    """The ranks reduce to one gradient, so Adam leaves the same
    parameters and statistics on each, bit for bit, with no broadcast."""
    _, _, _, ranks, *_ = setup
    a, b = ranks[0][draws]["state"], ranks[1][draws]["state"]
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_accumulated_alternating_steps_match_one_rank(setup):
    """Four micro-steps with accumulate_steps 2 and alternating_ratio 1
    (two Adam updates, each freezing its half): each rank reduces every
    micro-step's gradient before accumulating, both ranks freeze the
    same half, and the parameters stay within 3 lr an update of the
    1-rank run's (under 5e-3 of them apart by more than 0.5 lr), bit-equal
    across the ranks, with the same counters."""
    conf, _, _, _, flat0, batch = setup
    conf = dict(conf, accumulate_steps=2,
                model_conf=dict(conf["model_conf"], alternating_ratio=1))
    trainer = make_trainer(conf, flat0)
    for _ in range(4):
        trainer.train_step(batch)
    assert (trainer.updates, trainer.mini_step) == (2, 0)
    from behindthescenes_tpu_torch.weights import flat_from_state_dict
    want = flat_from_state_dict(trainer.net.state_dict())
    ranks = run_ranks(micro_steps_rank, WORLD, (conf, flat0, batch, 4),
                      timeout=SPAWN_TIMEOUT)
    lr = conf["learning_rate"]
    for r, res in enumerate(ranks):
        assert (res["updates"], res["mini_step"]) == (2, 0), r
        total = moved = 0
        for k, v in want.items():
            diff = np.abs(res["net"][k] - v)
            if k.startswith("params/"):
                total += diff.size
                moved += int((diff > 0.5 * lr).sum())
                assert diff.max() < 2 * 3 * lr, (r, k)
            else:
                np.testing.assert_allclose(res["net"][k], v, rtol=0,
                                           atol=1e-6, err_msg=k)
        assert moved / total < 5e-3, (r, moved, total)
    for k in want:
        np.testing.assert_array_equal(ranks[0]["net"][k], ranks[1]["net"][k],
                                      err_msg=k)
