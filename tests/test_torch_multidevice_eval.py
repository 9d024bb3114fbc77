"""The port's evaluators with each frame's rays (or the occupancy grid's
points) shared by two ranks against one rank (counterpart of
tests/test_multidevice_eval.py, at its sizes: ResNet-18 at 32x48, 8
samples).

Two ranks over gloo (`parallel.launch.run_ranks`) run the depth general
path, NVS, renders of a 15x21 frame (315 rays, which do not divide the
ranks: one chunk, several chunks a rank, and with a fine pass), the
occupancy density query of 3777 points in chunks of 256 points a rank,
and a sweep frame at warp 0.5 and exact; the same run on one rank is the
reference. Every rank must return the whole frame, and the same values as
one rank: rtol 1e-5, atol 1e-5 (the sigmas atol 1e-6). The draws are the
same because a shared frame draws its jitter whole before it is cut.
"""
import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch.parallel.launch import run_ranks
from tests.torch_dist_ranks import evaluations, evaluations_rank

# One intra-op thread: pytest-xdist runs several workers on this CPU.
torch.set_num_threads(1)

WORLD = 2
SPAWN_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def runs():
    single = evaluations(None)
    ranks = run_ranks(evaluations_rank, WORLD, ({},), timeout=SPAWN_TIMEOUT)
    return single, ranks


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}", rtol, atol)
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", ["depth", "nvs"])
def test_evaluator_sharded_matches_single_rank(runs, name):
    """The depth general path's and NVS's metrics on each rank (the
    evaluators engage the group) equal one rank's."""
    single, ranks = runs
    assert not single[f"{name}_group"]
    for r, res in enumerate(ranks):
        assert res[f"{name}_group"], r
        _close(res[name], single[name], f"rank {r} {name}")


@pytest.mark.parametrize("name", ["frame", "frame_chunks", "frame_fine"])
def test_sharded_render_nondivisible_rays(runs, name):
    """A 315-ray frame shared by 2 ranks (the last share padded): every
    output of both branches, on every rank, equals one rank's render."""
    single, ranks = runs
    assert 15 * 21 % WORLD != 0
    for r, res in enumerate(ranks):
        _close(res[name], single[name], f"rank {r} {name}")


def test_occupancy_query_sharded_matches_single_rank(runs):
    """The dense density query, each rank over its share of the points in
    chunks of 256 (the padded tail included), equals one rank's."""
    single, ranks = runs
    for r, res in enumerate(ranks):
        assert res["occ_group"], r
        _close(res["sigmas"], single["sigmas"], f"rank {r} sigmas",
               atol=1e-6)


@pytest.mark.parametrize("name", ["sweep", "sweep_exact"])
def test_sweep_frame_sharded_matches_single_rank(runs, name):
    """A sweep frame (32x48: its rays divide the ranks) at warp 0.5 and
    exact, shared by 2 ranks, equals one rank's (the counterpart of
    tests/test_sweep.py::test_sweep_multidevice_matches_single)."""
    single, ranks = runs
    for r, res in enumerate(ranks):
        _close(res[name], single[name], f"rank {r} {name}")
