"""The plain reference against the port at a small size on the CPU: the
training loss and every leaf's gradient with both in float64 (the port's
trainer computes in float64 with its parameters in float64), and the
self-view depth with the port in float32."""
import numpy as np
import pytest
import torch

from port_bench import calibrate, check, traffic
from port_bench import port_api as port
from port_bench.reference.train import follow, leaf_norms
from port_bench.tests import tiny
from port_bench.weights import make_weights


def port_float64_steps(conf, pool, seed):
    from behindthescenes_tpu_torch.training.trainer import (BTSTrainer,
                                                            make_optimizer)
    tr = BTSTrainer(conf, device="cpu", compute_dtype=torch.float64)
    tr.net.double()
    tr.net.load_state_dict(make_weights(conf["model_conf"], seed, "cpu"))
    tr.optimizer, tr.lr_schedule = make_optimizer(conf, tr.net.parameters())
    if tr.accumulate_steps > 1:
        tr.acc_grads = {n: torch.zeros_like(p)
                        for n, p in tr.net.named_parameters()}
    names = list(port.parameters(tr))
    start = {n: p.detach().clone() for n, p in tr.net.named_parameters()}
    losses, eas, grad = [], [], None
    for batch, draws in pool:
        b = {k: v.double() for k, v in batch.items()}
        d = dict(draws, z_jitter=draws["z_jitter"].double())
        out = tr.train_step(b, port.port_draws(d))
        losses.append(float(out["loss"]))
        eas.append(float(out["loss_eas"]))
        if grad is None:
            grad = leaf_norms(port.first_gradient(tr), names).numpy()
    change = np.array([float((p.detach() - start[n]).norm())
                       for n, p in tr.net.named_parameters()])
    return {"loss": losses, "eas": eas, "grad": grad, "change": change}


@pytest.mark.parametrize("workload", ["kitti360.train", "re10k.train"])
def test_train_steps_match_in_float64(workload):
    seed = tiny.SEED
    over, _ = tiny.cut(workload)
    conf, mix = calibrate.cell_conf(workload, over)
    conf["seed"] = seed
    mix["pool"] = mix["check_steps"]
    pool = traffic.train_pool(conf, mix, seed, torch.device("cpu"))
    got = port_float64_steps(conf, pool, seed)
    ref = follow(conf, make_weights(conf["model_conf"], seed, "cpu"), pool,
                 seed, "float64")
    numbers = check.train_numbers(got, ref)
    # The draws and a few of the port's geometry steps stay float32.
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_median_gap"] < 1e-5
    assert numbers["eas_gap"] < 1e-6
    assert numbers["change_gap"] < 1e-4
    assert all(np.isfinite(ref["loss"])) and min(ref["loss"]) > 0


def test_depth_matches_in_float32():
    over, mix = tiny.cut("kitti360.depth", bf16=False)
    got = calibrate.depth_readings("kitti360.depth", tiny.SEED,
                                   torch.device("cpu"), False, 4,
                                   overrides=over, mix_overrides=mix)
    # float32 against float32: rounding in the order of the sums only,
    # a thousandth of what bfloat16 rounding moves the same frames
    assert got["program"]["depth_gap_ratio"] < 1e-3


def test_leaf_gap_uses_median_floor():
    want = np.array([1.0, 1.0, 1e-9])
    got = np.array([1.0, 1.1, 2e-9])
    assert check.leaf_gap(got, want) == pytest.approx(0.1)
    assert check.leaf_gap(got, want, keep=np.array([True, False, True])) \
        == pytest.approx(1e-9)


def test_judge_rejects_nan_and_excess():
    ok, out = check.judge({"a": 0.1, "b": 0.2}, {"a": 0.5, "b": 0.3})
    assert ok and out["a"] == {"value": 0.1, "limit": 0.5}
    assert not check.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.judge({"a": 2.0}, {"a": 1.0})[0]
