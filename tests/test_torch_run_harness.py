"""The port's run harness (behindthescenes_tpu_torch/training/harness.py and
tasks.py) against the JAX package's on tests/test_harness.py's tiny config:
the checkpoint and best directories each leaves, best_value.json, the
auto-resume step, the SIGTERM stop and stop_iteration; the port's
checkpoint round-trips bit for bit; and the evaluation harness reads the
port's run and step directories and a reference `.pt` to the depth
metrics of the `.npz` they came from.
"""
import copy
import json
import os
import signal

import pytest
import torch

from behindthescenes_tpu.training.tasks import bts_training as j_training
from behindthescenes_tpu_torch.config import find_config, load_config
from behindthescenes_tpu_torch.evaluation import harness as eval_harness
from behindthescenes_tpu_torch.evaluation.tasks import evaluate_depth
from behindthescenes_tpu_torch.training import harness
from behindthescenes_tpu_torch.training.tasks import (bts_get_dataflow,
                                                      bts_training)
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from test_harness import _tiny_config
from test_torch_import import reference_bts_checkpoint

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "media", "weights", "synthetic_conv_step8400.npz")


def _config(out, stop, **kw):
    cfg = _tiny_config(out, stop)
    cfg["tensorboard"] = False
    cfg.update(kw)
    return cfg


def _steps(d):
    return sorted(int(x) for x in os.listdir(d) if x.isdigit())


def _run_both(tmp_path, stops, **kw):
    """The tiny config's run to each stop in turn (a new run each time, on
    one output_path), in both packages. Returns per package the
    checkpoint and best steps and best_value.json after each run, and the
    last run's step."""
    out = {}
    for name, run in (("jax", lambda c: int(j_training(c).step)),
                      ("port", lambda c: bts_training(c, device="cpu")
                       .step)):
        path = str(tmp_path / name)
        seen = []
        for stop in stops:
            step = run(_config(path, stop, **kw))
            with open(os.path.join(path, "best", "best_value.json")) as f:
                best = json.load(f)
            seen.append((step, _steps(os.path.join(path, "checkpoints")),
                         _steps(os.path.join(path, "best")), best))
        out[name] = seen
    return out


def test_checkpoints_best_and_resume_match_jax(tmp_path):
    """tests/test_harness.py's run in both packages, to iteration 11 and
    then resumed to 16: each stops where stop_iteration says, resumes at
    the next iteration (so it ends at 16), keeps the same checkpoint
    steps (5, 10, 11, then 11, 15, 16) and best steps, and writes
    best_value.json with the same keys, metric and step. Which
    validations improve depends on each package's own random
    initialisation and draws, so the learning rate is 0 here: the first
    validation (5) is the best in both, every later one equals it (each
    item drawn as at the first), and the resumed run carries its value
    over."""
    got = _run_both(tmp_path, (11, 16), learning_rate=0.0)
    for (jstep, jckpt, jbest, jval), (step, ckpt, best, val) in zip(
            got["jax"], got["port"]):
        assert step == jstep
        assert ckpt == jckpt
        assert best == jbest == [5]
        assert set(val) == set(jval) == {"metric", "signed_value", "value",
                                         "step"}
        assert val["metric"] == jval["metric"] == "abs_rel"
        assert val["step"] == jval["step"] == 5
    assert [s[0] for s in got["port"]] == [11, 16]
    assert [s[1] for s in got["port"]] == [[5, 10, 11], [11, 15, 16]]


def test_best_k_replaces_best_steps_as_jax(tmp_path, monkeypatch):
    """Both harnesses fed the same scripted validations: abs_rel 0.5, 0.4,
    0.3 at the 1st, 2nd and 3rd validation (iterations 5, 10 and, after
    the resume, 15), so the 2nd and the 3rd each replace the best. Both
    keep the same best steps (2 kept: 5 and 10, then 10 and 15) and
    best_value.json carries the same metric, value and step across the
    resume."""
    from behindthescenes_tpu.training import harness as j_harness
    script = (0.5, 0.4, 0.3)
    seen = {"jax": [], "port": []}

    def scripted(name, step):
        seen[name].append(step)
        return {"abs_rel": script[min(len(seen[name]), len(script)) - 1]}
    monkeypatch.setattr(j_harness, "run_validation",
                        lambda trainer, state, loader:
                        scripted("jax", int(state.step)))
    monkeypatch.setattr(harness, "run_validation",
                        lambda trainer, loader:
                        scripted("port", trainer.step))
    got = _run_both(tmp_path, (11, 16))
    assert seen["port"] == seen["jax"] == [5, 10, 15]
    for (jstep, jckpt, jbest, jval), (step, ckpt, best, val) in zip(
            got["jax"], got["port"]):
        assert (step, ckpt, best) == (jstep, jckpt, jbest)
        assert val == jval
    assert [s[2] for s in got["port"]] == [[5, 10], [10, 15]]
    assert [(s[3]["step"], s[3]["value"]) for s in got["port"]] == \
        [(10, 0.4), (15, 0.3)]


def test_checkpoint_round_trips(tmp_path):
    """The state saved at the stop, restored into a new trainer, equals the
    run's last state bit for bit: parameters, BatchNorm statistics,
    Adam's moments and count, the accumulator and every counter
    (accumulate_steps 2, stopped half-way through an accumulation)."""
    cfg = _config(str(tmp_path / "run"), 7, accumulate_steps=2,
                  checkpoint_every=1000, validate_every=1000)
    trainer = bts_training(cfg, device="cpu")
    assert trainer.step == 7 and trainer.mini_step == 1
    live = trainer.state_dict()
    fresh = BTSTrainer(cfg, device="cpu")
    fresh.init_state()
    mgr = harness.CheckpointManager(str(tmp_path / "run" / "checkpoints"))
    assert mgr.all_steps() == [7]
    step, extra = mgr.restore(fresh)
    assert step == 7 and extra == {"render_sched": {"iter_idx": 0,
                                                    "last_sched": 0}}
    back = fresh.state_dict()

    def same(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path
    same(live, back, "state")
    assert back["mini_step"] == 1 and back["step"] == 7


def test_sigterm_stop_and_resume(tmp_path):
    """A SIGTERM at iteration 7 (the real signal): the port's run saves 7
    and returns, as the JAX harness does; the handler is restored, and a
    new run resumes at 8 and stops at 12."""
    out = str(tmp_path / "run_sig")
    cfg = _config(out, 50, checkpoint_every=1000, validate_every=1000000)

    def on_iteration(it, trainer, loss_dict):
        if it == 7:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer = harness.base_training(cfg, bts_get_dataflow,
                                    on_iteration=on_iteration, device="cpu")
    assert trainer.step == 7
    assert _steps(os.path.join(out, "checkpoints")) == [7]
    assert signal.getsignal(signal.SIGTERM) is not harness._request_stop
    seen = []
    cfg2 = _config(out, 12, validate_every=1000000)
    trainer = bts_training(cfg2, device="cpu", on_iteration=lambda it, *_:
                           seen.append(it))
    assert seen == [8, 9, 10, 11, 12] and trainer.step == 12


def test_orbax_directories_are_refused(tmp_path):
    """A step directory of the JAX package (<step>/default/) is named in
    the refusal, in training and in evaluation."""
    (tmp_path / "checkpoints" / "15" / "default").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        harness.CheckpointManager(str(tmp_path / "checkpoints")).all_steps()
    conf = load_config(find_config("eval_synthetic"))
    from behindthescenes_tpu_torch.models.bts import BTSNet
    net = BTSNet.from_conf(conf["model_conf"])
    for path in (tmp_path, tmp_path / "checkpoints" / "15"):
        with pytest.raises(NotImplementedError, match="15"):
            eval_harness.load_eval_variables({"checkpoint": str(path)}, net)


def test_eval_harness_reads_port_runs_and_pt(tmp_path):
    """configs/eval_synthetic.yaml (ResNet-18, 8 scenes at 48x64, f32) with
    synthetic_conv_step8400.npz, and with the same weights as a run
    directory of the port's harness, one of its step directories, and a
    reference `.pt`: the same depth metrics, exactly."""
    conf = load_config(find_config("eval_synthetic"), {"bf16": False})
    trainer = BTSTrainer(copy.deepcopy(conf), device="cpu")
    trainer.init_state(NPZ)
    run = tmp_path / "run"
    harness.CheckpointManager(str(run / "checkpoints")).save(3, trainer)
    pt = tmp_path / "training.pt"
    torch.save(reference_bts_checkpoint(NPZ), pt)
    want = evaluate_depth(dict(conf, checkpoint=NPZ), device="cpu")
    assert want["abs_rel"] > 0
    for path in (run, run / "checkpoints" / "3", pt):
        got = evaluate_depth(dict(conf, checkpoint=str(path)), device="cpu")
        assert got == want, path


def test_train_cli_runs_the_overfit_task(tmp_path):
    """`python -m behindthescenes_tpu_torch.train -cn exp_synthetic
    model=bts_overfit ...` dispatches on the config's model, as the
    repository's train.py does: the learned map in place of the CNN on one
    cached batch (reference trainer_overfit.py), through the harness to
    stop_iteration, with its checkpoints."""
    from behindthescenes_tpu_torch import train as train_cli
    out = tmp_path / "overfit"
    trainer = train_cli.main([
        "-cn", "exp_synthetic", "model=bts_overfit", "--device", "cpu",
        f"output_path={out}", "stop_iteration=4", "checkpoint_every=2",
        "num_iters_per_epoch=3", "data.image_size=[24, 32]",
        "model_conf.ray_batch_size=64", "renderer.n_coarse=8"])
    assert trainer.step == 4
    assert type(trainer.net.encoder).__name__ == "EncoderDummy"
    assert _steps(out / "checkpoints") == [2, 4]
    with pytest.raises(ValueError, match="Unknown model"):
        train_cli.main(["-cn", "exp_synthetic", "model=other",
                        "--device", "cpu"])
