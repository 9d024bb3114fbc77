"""Gradient accumulation and alternating training in the port's trainer
against the JAX package's (optax.MultiSteps over Adam, `_alternating_mask`),
from the same initial variables, on the same batches, views and draws (the
draws replayed from the JAX step's keys, tests/test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu.training.trainer import TrainState
from behindthescenes_tpu_torch.training.trainer import (BTSTrainer,
                                                        alternating_half)
from behindthescenes_tpu_torch.weights import flat_from_state_dict, flax_key
from test_torch_train import (DUMMY, RESNET, _batch, _flat, _jax_init,
                              replay_draws)


class Pair:
    """A JAX trainer and the port's on one config from JAX's initial
    variables; `step(i)` runs micro-step i on both with the key
    PRNGKey(100 + i) and the draws replayed from it."""

    def __init__(self, spec, tmp_path, model_conf=(), **conf):
        self.conf = dict(spec["conf"], **conf)
        self.conf["model_conf"] = dict(self.conf["model_conf"],
                                       **dict(model_conf))
        self.shape = spec["shape"]
        self.batch = _batch(self.shape)
        self.jax = JTrainer(self.conf, mesh=make_mesh(jax.devices()[:1]),
                            compute_dtype=jnp.float32)
        variables = _jax_init(self.jax, self.batch, jax.random.PRNGKey(0))
        params = variables["params"]
        stats = variables.get("batch_stats", {})
        self.state = TrainState(params=params, batch_stats=stats,
                                opt_state=self.jax.tx.init(params),
                                step=jnp.asarray(0))
        self.jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.flat0 = {**_flat(params, "params/"),
                      **_flat(stats, "batch_stats/")}
        path = str(tmp_path / "init.npz")
        np.savez(path, **self.flat0)
        self.port = BTSTrainer(self.conf, compute_dtype=torch.float32,
                               device="cpu")
        self.port.init_state(path)
        self.v_loss = len(self.port.wrapper.select_views(
            np.random.default_rng(0), self.batch["imgs"].shape[1],
            training=True).ids_loss)

    def step(self, i):
        key = jax.random.PRNGKey(100 + i)
        self.state, jterms = self.jax.train_step(self.state, self.jbatch,
                                                 key, i)
        n, h, w = self.shape
        mc = self.conf["model_conf"]
        draws = replay_draws(key, n, self.v_loss, h, w, mc["patch_size"],
                             mc["ray_batch_size"],
                             self.conf["renderer"]["n_coarse"])
        terms = self.port.train_step(self.batch, draws)
        return ({k: float(v) for k, v in jterms.items()},
                {k: float(v) for k, v in terms.items()})

    def flats(self):
        want = {**_flat(self.state.params, "params/"),
                **_flat(self.state.batch_stats, "batch_stats/")}
        got = flat_from_state_dict(self.port.net.state_dict(),
                                   self.port.net.encoder.scales)
        return want, got


def _params(flat):
    return {k: v for k, v in flat.items() if k.startswith("params/")}


def test_accumulation_matches_multisteps(tmp_path):
    """accumulate_steps 2, batch 2, 4 micro-steps, f32, ResNet-18 at 32x48,
    from the same weights; a step schedule halving the learning rate at
    every update. Before the first update (micro-steps 1 and 2) the loss
    terms lie within 1e-5 relative of JAX's (measured 4.1e-6, and 1e-7
    absolute for terms at 0); after micro-step 1 the parameters are the
    initial ones bit for bit and the BatchNorm statistics have moved with
    JAX's (within 1e-5). After micro-step 3 the parameters are bit-equal
    to those after micro-step 2. At each update (micro-steps 2 and 4) the
    learning rate is the schedule's at the count of updates (1e-3, then
    5e-4), not at the micro-step, and the update has a cosine with JAX's
    of at least 0.999 at the first, 0.99 at the second.

    Past the first update the two runs part by more than the step's f32
    noise: Adam's first steps divide each gradient by its own magnitude,
    so entries whose gradient is near eps (1e-8; 1.6% of them here) turn
    the two backward passes' f32 noise into a visible share of the step,
    and a few change sign (measured: update cosines 0.99988 and 0.99842,
    signs apart on 6.7e-5 and 2.6e-3 of the entries; the second update's
    gradients are taken at parameters that differ already). So the loss
    terms of micro-steps 3 and 4 are held to 1e-4 relative (measured
    5.0e-5 and 2.0e-5). On the same gradients
    the update is held to 1e-4 x max|dtheta|
    (test_accumulation_update_on_the_same_gradients)."""
    pair = Pair(RESNET, tmp_path, accumulate_steps=2, learning_rate=1e-3,
                scheduler={"type": "step", "step_size": 1, "gamma": 0.5})
    prev = jprev = _params(pair.flat0)
    for i in range(4):
        jterms, terms = pair.step(i)
        assert set(terms) == set(jterms)
        for k, v in jterms.items():
            np.testing.assert_allclose(terms[k], v,
                                       rtol=1e-5 if i < 2 else 1e-4,
                                       atol=1e-7,
                                       err_msg=f"micro-step {i} {k}")
        want, got = pair.flats()
        if i % 2 == 0:
            assert pair.port.mini_step == 1
            for k, v in _params(got).items():
                np.testing.assert_array_equal(v, prev[k], err_msg=k)
            if i == 0:
                stats = [k for k in want if k.startswith("batch_stats/")]
                assert stats
                for k in stats:
                    np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                               rtol=1e-5, err_msg=k)
                assert any(not np.array_equal(got[k], pair.flat0[k])
                           for k in stats)
            continue
        assert pair.port.mini_step == 0 and pair.port.updates == i // 2 + 1
        lr = pair.port.optimizer.param_groups[0]["lr"]
        assert lr == pytest.approx(1e-3 * 0.5 ** (i // 2))
        keys = sorted(_params(want))
        d_want = np.concatenate([(want[k] - jprev[k]).ravel() for k in keys])
        d_got = np.concatenate([(got[k] - prev[k]).ravel() for k in keys])
        cos = float(d_got @ d_want / np.linalg.norm(d_got)
                    / np.linalg.norm(d_want))
        assert cos >= (0.999 if i == 1 else 0.99), (i, cos)
        prev, jprev = _params(got), _params(want)


def test_accumulation_update_on_the_same_gradients(tmp_path):
    """The accumulation and Adam alone: 6 micro-steps of the same random
    gradients (normal, 1e-3, from numpy) into optax.MultiSteps over
    optax.adam with the step schedule, as the JAX trainer builds it, and
    into the port's update, accumulate_steps 3. Parameters bit-equal to
    the previous ones on micro-steps that emit nothing, within 1e-4 x
    max|dtheta| of optax's after each update, or two f32 ulps of the
    parameter where that is larger (torch's Adam divides by its bias
    corrections in another order than optax, test_torch_train.py::
    test_adam_matches_optax; the learned map's entries near 1.5 have an
    ulp of 1.2e-7, above 1e-4 x 1e-3)."""
    pair = Pair(DUMMY, tmp_path, accumulate_steps=3, learning_rate=1e-3,
                scheduler={"type": "step", "step_size": 1, "gamma": 0.5})
    port, tx = pair.port, pair.jax.tx
    params = pair.state.params
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    names = {flax_key(n, port.net.encoder.scales)[0]: n
             for n, _ in port.net.named_parameters()}
    prev = _params(pair.flat0)
    for i in range(6):
        grads = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
                 for k, v in _params(pair.flat0).items()}
        tree = jax.tree_util.tree_map(lambda x: x, params)
        flat_tree = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [jnp.asarray(grads["params/" + "/".join(
                str(getattr(p, "key", p)) for p in kp)])
             for kp in flat_tree])
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for key, name in names.items():
            port.net.get_parameter(name).grad = torch.from_numpy(
                np.ascontiguousarray(np.transpose(grads[key], {
                    4: (3, 2, 0, 1), 2: (1, 0)}.get(grads[key].ndim,
                                                    tuple(range(
                                                        grads[key].ndim))))))
        port._update()
        port.step += 1
        want = _flat(params, "params/")
        got = _params(flat_from_state_dict(port.net.state_dict(),
                                           port.net.encoder.scales))
        if (i + 1) % 3:
            for k in got:
                np.testing.assert_array_equal(got[k], prev[k], err_msg=k)
            continue
        delta = max(float(np.abs(want[k] - prev[k]).max()) for k in want)
        assert delta > 0
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4 * delta,
                                       rtol=2.0 ** -22, err_msg=f"{i} {k}")
        prev = got


def test_accumulation_state_round_trips(tmp_path):
    """state_dict after an odd micro-step holds the half-filled accumulator
    and its counter; loaded into a new trainer, the next micro-step on
    both lands on bit-equal parameters."""
    pair = Pair(DUMMY, tmp_path, accumulate_steps=2)
    pair.step(0)
    saved = pair.port.state_dict()
    assert saved["mini_step"] == 1 and saved["step"] == 1
    assert any(float(a.abs().max()) > 0 for a in saved["acc_grads"].values())
    other = BTSTrainer(pair.conf, compute_dtype=torch.float32, device="cpu")
    other.init_state()
    other.load_state_dict(saved)
    n, h, w = pair.shape
    mc = pair.conf["model_conf"]
    draws = replay_draws(jax.random.PRNGKey(5), n, pair.v_loss, h, w,
                         mc["patch_size"], mc["ray_batch_size"],
                         pair.conf["renderer"]["n_coarse"])
    other.np_rng = np.random.default_rng(3)
    pair.port.np_rng = np.random.default_rng(3)
    other.train_step(pair.batch, draws)
    pair.port.train_step(pair.batch, draws)
    assert other.updates == pair.port.updates == 1
    for (n, a), (_, b) in zip(other.net.state_dict().items(),
                              pair.port.net.state_dict().items()):
        assert torch.equal(a, b), n


def test_alternating_ratio_freezes_halves(tmp_path):
    """alternating_ratio 1 (tests/test_train_modes.py:62-86 on the port):
    step 0 trains the encoder and freezes the coarse MLP, step 1 the
    other way round. In both packages the frozen half stays bit-equal to
    its value before the step and the other half moves; the step's loss
    terms lie within 1e-5 relative of JAX's before any update and 1e-4
    after one, and each update has a cosine of at least 0.999 with JAX's
    (Adam's first steps amplify the f32 noise of tiny gradients, as in
    test_accumulation_matches_multisteps)."""
    pair = Pair(DUMMY, tmp_path, model_conf={"alternating_ratio": 1},
                learning_rate=1e-3)
    assert pair.port.alternating_ratio == pair.jax.alternating_ratio == 1
    names = {flax_key(n, pair.port.net.encoder.scales)[0]:
             alternating_half(n) for n, _ in pair.port.net.named_parameters()}
    assert set(names.values()) >= {"encoder", "mlp"}
    prev = jprev = _params(pair.flat0)
    for i, frozen in ((0, "mlp"), (1, "encoder")):
        jterms, terms = pair.step(i)
        for k, v in jterms.items():
            np.testing.assert_allclose(terms[k], v, rtol=1e-5 if i == 0
                                       else 1e-4, atol=1e-7, err_msg=k)
        want, got = pair.flats()
        for k, v in _params(want).items():
            if names[k] == frozen:
                np.testing.assert_array_equal(got[k], prev[k], err_msg=k)
                np.testing.assert_array_equal(v, jprev[k], err_msg=k)
            elif names[k] is not None:
                assert not np.array_equal(got[k], prev[k]), k
        keys = sorted(_params(want))
        d_want = np.concatenate([(want[k] - jprev[k]).ravel() for k in keys])
        d_got = np.concatenate([(got[k] - prev[k]).ravel() for k in keys])
        cos = float(d_got @ d_want / np.linalg.norm(d_got)
                    / np.linalg.norm(d_want))
        assert cos >= 0.999, (i, cos)
        prev, jprev = _params(got), _params(want)
