"""The check catches what it is there to catch: a run with the timed
path broken underneath (the look for a card skipped, the rest of the run
as the driver's) comes out not correct, once for each fault the cell can
have, and so does the control (the reference computed in fp8 in the
program's place) at a size a test run can hold."""
import numpy as np
import pytest
import torch

from port_bench import calibrate, check, harness
from port_bench.tests import tiny

FAULTS = [("kitti360.train", "state_unchanged"),
          ("kitti360.train", "half_batch"),
          ("re10k.train", "state_unchanged"),
          ("re10k.train", "half_batch"),
          ("kitti360.depth", "answer_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    over, mix = tiny.cut(workload, bf16=False)
    result, _ = harness.run(workload, tiny.SEED, 0.5, False, device="cpu",
                            overrides=over, mix_overrides=mix, fault=fault)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("workload", ["kitti360.train", "re10k.train",
                                      "kitti360.depth"])
def test_control_is_not_correct(workload):
    over, mix = tiny.cut(workload)
    limits = check.load_limits(workload)
    dev = torch.device("cpu")
    if "depth" in workload:
        got = calibrate.depth_readings(workload, tiny.SEED, dev, True, 4,
                                       overrides=over, mix_overrides=mix)
    else:
        got = calibrate.train_readings(workload, tiny.SEED, dev, True,
                                       overrides=over, mix_overrides=mix)
    ok, compared = check.judge(got["control"], limits)
    assert not ok, compared
    assert all(np.isfinite(v) for v in got["control"].values())
