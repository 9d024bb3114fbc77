"""The data-parallel loop ("train_dp") on the CPU over gloo at tiny.cut's
size, two ranks: a sound run is correct with every rank's parameters
equal; each fault the cell can have, and the control, is not correct;
one rank reads as the one-card training loop; ranks that outlast their
time end the run; and the readers of the collectives' time."""
import numpy as np
import pytest
import torch

from port_bench import calibrate, check, harness, readers, trace
from port_bench.loops import train_dp
from port_bench.tests import tiny

WORKLOAD = "kitti360.train.dp4"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """The ranks compute on one thread; so does the reference here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_dp(fault=None, **mix):
    over, mix_over = tiny.cut(WORKLOAD, bf16=False)
    return harness.run(WORKLOAD, tiny.SEED, 0.5, False, device="cpu",
                       overrides=over, mix_overrides=dict(mix_over, **mix),
                       fault=fault)[0]


def test_two_ranks_are_correct_and_alike():
    result = run_dp()
    assert result["correct"] is True, result["check"]
    assert result["check"]["replica_gap"]["value"] == 0.0
    assert result["device"]["count"] == 2
    assert result["attempted"] % tiny.DP_MIX["stop_every"] == 0


@pytest.mark.parametrize("fault", ["allreduce_dropped", "shard_repeated",
                                   "half_batch", "state_unchanged"])
def test_fault_is_not_correct(fault):
    result = run_dp(fault)
    assert result["correct"] is False, result["check"]
    if fault == "allreduce_dropped":
        assert result["check"]["replica_gap"]["value"] > 0


def test_control_is_not_correct():
    over, mix = tiny.cut(WORKLOAD)
    rows = calibrate.dp_rows(WORKLOAD, [tiny.SEED], 1, [], 0, CPU, over, mix)
    ok, compared = check.judge(rows[0]["control"],
                               check.load_limits(WORKLOAD))
    assert not ok, compared


def test_one_rank_reads_as_the_train_loop():
    dp = run_dp(ranks=1)["check"]
    over, mix = tiny.cut("kitti360.train", bf16=False, accumulate_steps=1)
    one = harness.run("kitti360.train", tiny.SEED, 0.5, False, device="cpu",
                      overrides=over, mix_overrides=mix)[0]["check"]
    for name in ("grad_median_gap", "change_gap"):
        assert dp[name]["value"] == one[name]["value"]
    assert dp["first_loss_gap"]["value"] <= one["loss_gap"]["value"]
    assert dp["first_eas_gap"]["value"] <= one["eas_gap"]["value"]
    assert dp["replica_gap"]["value"] == 0.0


def test_loss_and_smoothness_are_the_first_steps():
    """Later steps' gaps, however wide, are not the compared ones."""
    names = ["a", "b"]
    ref = {"loss": [0.5, 0.5, 0.5], "eas": [0.02, 0.02, 0.02],
           "grad": np.array([1.0, 2.0]), "change": np.array([1.0, 1.0]),
           "names": names}
    prog = dict(ref, loss=[0.5005, 0.6, 0.7], eas=[0.0201, 0.05, 0.09],
                replica_gap=0.0)
    got = train_dp.numbers(prog, ref)
    assert set(got) == set(check.load_limits(WORKLOAD))
    assert got["first_loss_gap"] == pytest.approx(1e-3)
    assert got["first_eas_gap"] == pytest.approx(5e-3)


def test_ranks_past_their_time_end_the_run():
    with pytest.raises(RuntimeError, match="still running"):
        run_dp(rank_timeout_s=0.5)


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_allreduce_readers():
    """Two micro-steps: a collective of 10 us of which 3 run beside a
    kernel, and one of 7 us beside a copy for 2."""
    events = [ev("ncclDevKernel_AllReduce", 0, 10), ev("conv", 5, 3),
              ev("ncclDevKernel_AllReduce", 20, 7),
              ev("Memcpy DtoD", 25, 5, "gpu_memcpy")]
    run = harness.Run(WORKLOAD, {}, {})
    run.trace = dict(trace.reduce_events(events), count=2, window_s=1.0)
    ms = harness.load_reader("train.allreduce_ms")(run)
    exposed = harness.load_reader("train.allreduce_exposed_ms")(run)
    assert ms == pytest.approx(1e-3 * 17 / 2)
    assert exposed == pytest.approx(1e-3 * (7 + 5) / 2)
    run.trace = dict(trace.reduce_events(events[1:2]), count=2,
                     window_s=1.0)
    assert harness.load_reader("train.allreduce_ms")(run) is None
    assert harness.load_reader("train.allreduce_exposed_ms")(run) is None


def test_mfu_is_over_the_cards_the_run_used():
    run = harness.Run(WORKLOAD, {}, {})
    run.trace, run.window_s, run.count = {}, 2.0, 3
    run.work_flops = 4 * 989e12
    run.chips = 4
    assert readers.mfu(run) == pytest.approx(100.0 * 3 / 2.0)
