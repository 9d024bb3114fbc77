"""A checkpoint saved at one world size resumes at another (counterpart
of tests/test_topology_resume.py): a step of the global batch at 2 ranks
(gloo, `parallel.launch.run_ranks`; rank 0 writes) restored into one
rank, and a step at 1 rank restored into 2 ranks. The restored
parameters, BatchNorm statistics, Adam state and counters are bit-equal
to the saved ones, and the next step of the same global batch runs to a
finite loss that equals on every rank."""
import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch.parallel.launch import run_ranks
from behindthescenes_tpu_torch.training.harness import CheckpointManager
from behindthescenes_tpu_torch.training.trainer import BTSTrainer, init_params
from behindthescenes_tpu_torch.weights import flat_from_state_dict
from tests.test_multidevice_equiv import _tiny_config
from tests.torch_dist_ranks import (make_trainer, np_batch,
                                    resume_and_step_rank,
                                    save_after_step_rank)

# One intra-op thread: pytest-xdist runs several workers on this CPU.
torch.set_num_threads(1)

SPAWN_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def start():
    conf = _tiny_config()
    trainer = BTSTrainer(conf, compute_dtype=torch.float32, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init_params(trainer.net, gen)
    return conf, flat_from_state_dict(trainer.net.state_dict()), \
        np_batch(32, 48, 8)


def _assert_state_equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_state_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def test_resume_2rank_to_1rank(start, tmp_path):
    conf, flat, batch = start
    saved = run_ranks(save_after_step_rank, 2,
                      (conf, flat, batch, str(tmp_path)),
                      timeout=SPAWN_TIMEOUT)
    _assert_state_equal(saved[0]["net"], saved[1]["net"], "ranks")
    trainer = make_trainer(conf, flat)
    step, _ = CheckpointManager(str(tmp_path)).restore(trainer)
    assert step == 1
    _assert_state_equal(trainer.state_dict()["net"], saved[0]["net"], "net")
    _assert_state_equal(trainer.optimizer.state_dict(),
                        saved[0]["optimizer"], "optimizer")
    assert (trainer.step, trainer.updates) == (1, 1)
    terms = trainer.train_step(batch)
    assert np.isfinite(float(terms["loss"]))
    assert trainer.updates == 2


def test_resume_1rank_to_2rank(start, tmp_path):
    conf, flat, batch = start
    trainer = make_trainer(conf, flat)
    trainer.train_step(batch)
    CheckpointManager(str(tmp_path)).save(trainer.step, trainer)
    want = trainer.state_dict()
    ranks = run_ranks(resume_and_step_rank, 2,
                      (conf, flat, batch, str(tmp_path)),
                      timeout=SPAWN_TIMEOUT)
    for r, res in enumerate(ranks):
        assert res["restored"]["step"] == 1, r
        _assert_state_equal(res["restored"]["net"], want["net"], f"net {r}")
        _assert_state_equal(res["restored"]["optimizer"], want["optimizer"],
                            f"optimizer {r}")
        assert np.isfinite(res["terms"]["loss"]), r
    assert ranks[0]["terms"] == ranks[1]["terms"]
