"""Cuts of the cells that a CPU test run can hold: every width as
published, smaller images, batches, ray counts and pools."""

TRAIN = {"data": {"image_size": [64, 96]}, "batch_size": 2,
         "model_conf": {"ray_batch_size": 256}}
DEPTH = {"data": {"image_size": [64, 96]}}
TRAIN_MIX = {"pool": 5}
DEPTH_MIX = {"pool": 4, "mark_every": 2, "check_frames": 3,
             "warm_frames": 2}
SEED = 2_147_483_901


def cut(workload: str, **extra):
    """(overrides, mix_overrides) of a workload, with `extra` merged into
    the overrides."""
    if "depth" in workload:
        return dict(DEPTH, **extra), dict(DEPTH_MIX)
    return dict(TRAIN, **extra), dict(TRAIN_MIX)
