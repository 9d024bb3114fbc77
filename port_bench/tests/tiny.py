"""Cuts of the cells that a CPU test run can hold: every width as
published, smaller images, batches, ray counts and pools, and two
data-parallel ranks."""
from port_bench import harness

TRAIN = {"data": {"image_size": [64, 96]}, "batch_size": 2,
         "model_conf": {"ray_batch_size": 256}}
DEPTH = {"data": {"image_size": [64, 96]}}
TRAIN_MIX = {"pool": 5}
DP_MIX = {"pool": 5, "ranks": 2, "stop_every": 2}
DEPTH_MIX = {"pool": 4, "mark_every": 2, "check_frames": 3,
             "warm_frames": 2}
SEED = 2_147_483_901


def cut(workload: str, **extra):
    """(overrides, mix_overrides) of a workload, with `extra` merged into
    the overrides."""
    loop = harness.load_spec(workload)[3]["loop"]
    if loop == "depth_stream":
        return dict(DEPTH, **extra), dict(DEPTH_MIX)
    return dict(TRAIN, **extra), dict(DP_MIX if loop == "train_dp"
                                      else TRAIN_MIX)
