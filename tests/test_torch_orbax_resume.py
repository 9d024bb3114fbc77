"""Resuming a JAX training run in the port: the JAX trainer (optax.MultiSteps
over Adam, accumulate_steps 2) takes three micro-steps and its
CheckpointManager saves the state at micro-step 3, with half an
accumulated gradient; tools/orbax_to_port.py turns that orbax step into
the port's `<step>/state.pt` (training/harness.py::state_from_jax); the
port's CheckpointManager restores it. Then both sides take micro-step 3
from the restored state, which completes the second update.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.harness import \
    CheckpointManager as JCheckpoints
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu.training.trainer import TrainState
from behindthescenes_tpu_torch.training.harness import (CheckpointManager,
                                                        state_from_jax)
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.weights import flat_from_state_dict
from test_torch_train import RESNET, _batch, _flat, _jax_init, replay_draws

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = dict(RESNET["conf"], accumulate_steps=2, learning_rate=1e-3,
            scheduler={"type": "step", "step_size": 1, "gamma": 0.5})
SAVED_AT = 3           # micro-steps before the checkpoint: one half-filled
# chip_smoke.py phase 7's bounds on a step against its reference.
LOSS_RTOL, GRAD_NORM_RTOL, GRAD_NORM_FLOOR = 1e-4, 1e-3, 1e-6
UPDATE_NORM_RTOL = 1e-3   # each tensor's applied change, in norm


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_port", os.path.join(ROOT, "tools", "orbax_to_port.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(i):
    return jax.random.PRNGKey(100 + i)


def _draws(trainer, key):
    n, h, w = RESNET["shape"]
    mc = CONF["model_conf"]
    v_loss = len(trainer.wrapper.select_views(
        np.random.default_rng(0), 4, training=True).ids_loss)
    return replay_draws(key, n, v_loss, h, w, mc["patch_size"],
                        mc["ray_batch_size"], CONF["renderer"]["n_coarse"])


def _jax_trainer():
    return JTrainer(CONF, mesh=make_mesh(jax.devices()[:1]),
                    compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX run saved at SAVED_AT with its render scheduler, the
    converted port step directory and the JAX trainer's pieces."""
    base = tmp_path_factory.mktemp("orbax")
    batch = _batch(RESNET["shape"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    trainer = _jax_trainer()
    variables = _jax_init(trainer, batch, jax.random.PRNGKey(0))
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=trainer.tx.init(variables["params"]),
                       step=jnp.asarray(0))
    for i in range(SAVED_AT):
        state, _ = trainer.train_step(state, jbatch, _key(i), i)
    jdir = str(base / "jax" / "checkpoints")
    JCheckpoints(jdir).save(SAVED_AT, state, extra={
        "render_sched": trainer.scheduler.state_dict()})
    out = str(base / "port" / "checkpoints")
    step_dir = _tool().convert(jdir, CONF, out)
    return {"jdir": jdir, "out": out, "step_dir": step_dir, "batch": batch,
            "jbatch": jbatch, "template": state}


def test_converted_state_restores_exactly(run):
    """The port's restored trainer against the tree JAX restores:
    parameters, BatchNorm statistics, Adam's moments and the half-filled
    accumulator bit for bit, and the counters (micro-steps 3, updates 1,
    accumulated 1, Adam's count 1); the render scheduler carried over."""
    assert run["step_dir"] == os.path.join(run["out"], str(SAVED_AT))
    tree = jax.tree_util.tree_map(
        np.asarray, JCheckpoints(run["jdir"]).restore_replicated(SAVED_AT))
    opt = tree["opt_state"]
    adam = opt["inner_opt_state"][0]
    assert int(opt["mini_step"]) == 1 and int(opt["gradient_step"]) == 1
    acc = _flat(opt["acc_grads"], "params/")
    assert any(np.abs(v).max() > 0 for v in acc.values())

    trainer = BTSTrainer(CONF, compute_dtype=torch.float32, device="cpu")
    trainer.init_state()
    step, extra = CheckpointManager(run["out"]).restore(trainer)
    assert step == SAVED_AT
    with open(os.path.join(run["jdir"], f"extra_{SAVED_AT}.json")) as f:
        assert extra == json.load(f)
    assert trainer.scheduler.state_dict() == extra["render_sched"]
    assert (trainer.step, trainer.updates, trainer.mini_step) == (3, 1, 1)

    scales = trainer.net.encoder.scales
    got = flat_from_state_dict(trainer.net.state_dict(), scales)
    want = {**_flat(tree["params"], "params/"),
            **_flat(tree["batch_stats"], "batch_stats/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    names = [n for n, _ in trainer.net.named_parameters()]
    opt_state = trainer.optimizer.state_dict()["state"]
    for moment, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        got = flat_from_state_dict(
            {n: opt_state[i][moment] for i, n in enumerate(names)}, scales)
        want = _flat(adam[leaf], "params/")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert {float(s["step"]) for s in opt_state.values()} == \
        {float(adam["count"])} == {1.0}
    got = flat_from_state_dict(trainer.acc_grads, scales)
    for k in acc:
        np.testing.assert_array_equal(got[k], acc[k], err_msg=k)


def test_resumed_step_matches_jax(run):
    """Micro-step 3 from the restored state on both sides (fresh trainers,
    as a resumed run has: the same views; the draws replayed from JAX's
    key) completes the second update. The loss terms within LOSS_RTOL of
    JAX's resumed step; the completed update's gradient (the mean of the
    two accumulated micro-steps: the restored half plus this step's
    gradient, as optax.MultiSteps forms it from JAX's own gradient of
    this step) within GRAD_NORM_RTOL in each tensor's norm; the counters
    as JAX's (updates 2, accumulator empty), each tensor's applied change
    within UPDATE_NORM_RTOL of JAX's in norm, and the whole change a
    cosine of at least 0.999 with JAX's."""
    jtrainer = _jax_trainer()
    restored, _ = JCheckpoints(run["jdir"]).restore(run["template"])
    before = _flat(restored.params, "params/")
    acc = _flat(restored.opt_state.acc_grads, "params/")
    key = _key(SAVED_AT)
    ids = jtrainer.wrapper.select_views(np.random.default_rng(CONF["seed"]),
                                        4, training=True)
    wrapper, criterion = jtrainer.wrapper, jtrainer.criterion

    def loss_fn(params, batch_stats):
        data, _ = wrapper.forward({"params": params,
                                   "batch_stats": batch_stats},
                                  run["jbatch"], key, ids, train=True)
        return criterion(data)[0]
    grads = _flat(jax.jit(jax.grad(loss_fn))(restored.params,
                                             restored.batch_stats),
                  "params/")
    after, jterms = jtrainer.train_step(restored, run["jbatch"], key,
                                        SAVED_AT)
    assert int(after.opt_state.gradient_step) == 2
    assert int(after.opt_state.mini_step) == 0

    trainer = BTSTrainer(CONF, compute_dtype=torch.float32, device="cpu")
    trainer.init_state()
    CheckpointManager(run["out"]).restore(trainer)
    terms = trainer.train_step(run["batch"], _draws(trainer, key))
    assert (trainer.step, trainer.updates, trainer.mini_step) == (4, 2, 0)
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k]), float(v),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)

    scales = trainer.net.encoder.scales
    got = flat_from_state_dict({n: p.grad for n, p in
                                trainer.net.named_parameters()}, scales)
    assert sorted(got) == sorted(grads)
    worst = 0.0
    for k, g in grads.items():
        mean = acc[k] + (g - acc[k]) / 2
        want = float(np.linalg.norm(mean))
        rel = abs(float(np.linalg.norm(got[k])) - want) / max(
            want, GRAD_NORM_FLOOR)
        worst = max(worst, rel)
    assert worst <= GRAD_NORM_RTOL, worst
    assert all(not np.any(a.numpy()) for a in trainer.acc_grads.values())

    got = flat_from_state_dict(trainer.net.state_dict(), scales)
    want = _flat(after.params, "params/")
    keys = sorted(want)
    d_want = {k: want[k] - before[k] for k in keys}
    d_got = {k: got[k] - before[k] for k in keys}
    # The update's size: each tensor's change within UPDATE_NORM_RTOL of
    # JAX's in norm (a learning rate of the wrong update index, or a
    # wrong bias correction, scales it), and the whole change in
    # direction.
    worst = max(abs(float(np.linalg.norm(d_got[k]))
                    - float(np.linalg.norm(d_want[k])))
                / max(float(np.linalg.norm(d_want[k])), GRAD_NORM_FLOOR)
                for k in keys)
    assert worst <= UPDATE_NORM_RTOL, worst
    flat_want = np.concatenate([d_want[k].ravel() for k in keys])
    flat_got = np.concatenate([d_got[k].ravel() for k in keys])
    cos = float(flat_got @ flat_want / np.linalg.norm(flat_got)
                / np.linalg.norm(flat_want))
    assert cos >= 0.999, cos


def test_port_refuses_orbax_by_name(run):
    """The port still reads no orbax step directory itself, and says which
    tool converts one."""
    with pytest.raises(NotImplementedError, match="orbax_to_port"):
        CheckpointManager(run["jdir"]).latest_step()


def test_state_from_jax_refuses_a_mismatched_config(run):
    """A checkpoint with an accumulator against a config without one."""
    tree = jax.tree_util.tree_map(
        np.asarray, JCheckpoints(run["jdir"]).restore_replicated(SAVED_AT))
    trainer = BTSTrainer(dict(CONF, accumulate_steps=1),
                         compute_dtype=torch.float32, device="cpu")
    trainer.init_state()
    with pytest.raises(ValueError, match="accumulate_steps"):
        state_from_jax(tree, trainer)
