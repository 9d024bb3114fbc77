"""`python -m behindthescenes_tpu_torch.scripts.gen_orbslam_settings`
against the repository's scripts/datasets/gen_orbslam_settings.py: the
files written byte for byte equal, on the calibration of
tests/test_dataset_tooling.py::test_gen_orbslam_settings and on the one
the port's synthetic KITTI raw generator writes."""
import os
import sys

import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_raw as gen
from behindthescenes_tpu_torch.scripts import gen_orbslam_settings
from test_media_scripts import load_script

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)


def _tooling_calibration(data):
    """tests/test_dataset_tooling.py:205-218's day."""
    day = "2011_09_26"
    (data / day).mkdir(parents=True)
    fx, fy, cx, cy, b = 721.5377, 721.5377, 609.5593, 172.854, 0.53267221
    p_l = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])
    p_r = p_l.copy()
    p_r[0, 3] = -b * fx
    with open(data / day / "calib_cam_to_cam.txt", "w") as f:
        f.write("P_rect_02: " + " ".join(map(str, p_l.ravel())) + "\n")
        f.write("P_rect_03: " + " ".join(map(str, p_r.ravel())) + "\n")
        f.write("S_rect_02: 1242 375\n")


def _synthetic_calibration(data):
    gen.generate_tree(data, n_frames=3, test_keyframes=[1], size=(20, 60))


@pytest.mark.parametrize("make", [_tooling_calibration,
                                  _synthetic_calibration],
                         ids=["tooling", "synthetic_kitti_raw"])
def test_settings_byte_equal_to_jax_script(make, tmp_path, monkeypatch,
                                           capsys):
    data = tmp_path / "data"
    make(data)
    mod = load_script("scripts/datasets/gen_orbslam_settings.py")
    monkeypatch.setattr(sys, "argv", ["gen", "-d", str(data), "-o",
                                      str(tmp_path / "jax")])
    mod.main()
    written = gen_orbslam_settings.main(["-d", str(data), "-o",
                                         str(tmp_path / "port")])
    assert [p.name for p in written] == ["2011_09_26.yaml"]
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert capsys.readouterr().out.count("wrote") == 2


def test_refuses_a_tree_without_calibrations(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no day directories"):
        gen_orbslam_settings.main(["-d", str(tmp_path / "empty"), "-o",
                                   str(tmp_path / "out")])
