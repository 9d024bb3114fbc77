"""The port's RealEstate10K loader (behindthescenes_tpu_torch/datasets/
realestate10k.py) against the JAX package's, on a copy of the JAX test's
tree (tests/test_realestate10k.py: one sequence of eight 72x128 noise
frames written by cv2, w2c poses along x): every item of the training
split, the test index, `dilation: random` (the same draws) and the colour
jitter, images bit-equal (the port decodes with its own JPEG reader, JAX
with cv2), poses and projections within 1e-6; and the synthetic tree the
port generates."""
import pickle

import cv2
import numpy as np
import pytest
import torch

from behindthescenes_tpu.datasets.realestate10k import \
    RealEstate10kDataset as JDataset
from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets import gen_synthetic_re10k as gen
from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.realestate10k import \
    RealEstate10kDataset

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def re10k_tree(tmp_path_factory):
    """tests/test_realestate10k.py's fixture, rebuilt from the same seed
    (copied, not imported)."""
    root = tmp_path_factory.mktemp("re10k")
    rng = np.random.default_rng(0)
    key = "abc123"
    n = 8
    timestamps = [1000 + 100 * i for i in range(n)]
    # w2c 3x4 poses moving along x.
    poses = []
    for i in range(n):
        p = np.eye(4)
        p[0, 3] = -0.1 * i   # w2c translation
        poses.append(p[:3])
    intrinsics = np.tile(np.array([0.9, 1.2, 0.5, 0.5]), (n, 1))
    seq = {key: {"timestamps": timestamps,
                 "poses": np.stack(poses).astype(np.float32),
                 "intrinsics": intrinsics.astype(np.float32)}}
    for split in ("train", "test"):
        with open(root / f"{split}.pickle", "wb") as f:
            pickle.dump(seq, f)
        d = root / "frames" / split / key
        d.mkdir(parents=True)
        for ts in timestamps:
            img = rng.integers(0, 255, (72, 128, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{ts}.jpg"), img)
    with open(root / "index.txt", "w") as f:
        f.write(f"{key} 3\n")
    return root


def _assert_items_equal(want, got):
    assert set(got) == set(want)
    for k in ("imgs", "depths"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("projs", "poses"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)


# keyword arguments of both loaders
LOADS = {
    "train_fc2": dict(target_image_size=(36, 64), frame_count=2),
    "train_fc3_dilation2": dict(target_image_size=(36, 64), frame_count=3,
                                dilation=2),
    "test_index": dict(target_image_size=(36, 64), frame_count=2,
                       dilation=10, split="index.txt"),
    "random_dilation_fc2": dict(target_image_size=(36, 64), frame_count=2,
                                dilation="random", seed=5),
    "random_dilation_fc3_jitter": dict(target_image_size=(36, 64),
                                       frame_count=3, dilation="random",
                                       color_aug=True, seed=2),
    "jitter_fc2": dict(target_image_size=(48, 80), frame_count=2,
                       color_aug=True),
}


@pytest.mark.parametrize("case", sorted(LOADS))
def test_items_match_jax(case, re10k_tree):
    """Every item in order, so that the random dilations and the jitters
    come from the same draws of the datasets' generators."""
    kw = dict(LOADS[case])
    split = kw.pop("split", None)
    if split:
        kw["split_path"] = str(re10k_tree / split)
    want = JDataset(str(re10k_tree), **kw)
    got = RealEstate10kDataset(str(re10k_tree), **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        _assert_items_equal(want[i], got[i])
    if split:
        np.testing.assert_allclose(got[0]["poses"][0][0, 3], 0.3, atol=1e-6)


def test_make_train_test_matches_jax(re10k_tree):
    """configs/data/re10k.yaml with exp_re10k's data keys (data_fc 3,
    dilation random, color_aug) through the port's factory: the training
    set's items and the test set's (test_dilation 10) equal JAX's."""
    conf = load_config(find_config("exp_re10k"), parse_cli_overrides([
        f"data.data_path={re10k_tree}",
        f"data.split_path={re10k_tree / 'index.txt'}",
        "data.image_size=[36, 64]"]))["data"]
    assert conf["dilation"] == "random" and conf["data_fc"] == 3
    jtrain, jtest = JDataset.make_train_test(conf)
    train, test = make_datasets(conf)
    assert test.dilation == 10 and train.color_aug
    for want, got in ((jtrain, train), (jtest, test)):
        assert len(got) == len(want)
        for i in range(len(want)):
            _assert_items_equal(want[i], got[i])
    assert train[0]["imgs"].shape == (3, 36, 64, 3)


def test_generated_tree_loads(tmp_path):
    """The port's synthetic tree at a cut size: both pickles, the frames
    and the index; the JAX loader (cv2) and the port's read it alike; the
    intrinsics are the indoor family's NDC values and consecutive frames
    are STEP apart."""
    gen.generate_tree(tmp_path, n_frames=12, test_keyframes=(0, 1),
                      size=(36, 64))
    with open(tmp_path / "test_index.txt") as f:
        assert len(f.readlines()) == 2
    for kw in (dict(split_path=str(tmp_path / "test_index.txt"),
                    dilation=10),
               dict(frame_count=3, dilation="random")):
        want = JDataset(str(tmp_path), target_image_size=(32, 48), **kw)
        got = RealEstate10kDataset(str(tmp_path),
                                   target_image_size=(32, 48), **kw)
        assert len(got) == len(want)
        for i in range(len(want)):
            _assert_items_equal(want[i], got[i])
    item = got[0]
    np.testing.assert_allclose(item["projs"][0],
                               [[1.2, 0, 0], [0, 1.8, 0], [0, 0, 1]],
                               atol=1e-6)
    test = RealEstate10kDataset(str(tmp_path),
                                split_path=str(tmp_path / "test_index.txt"),
                                target_image_size=(32, 48), dilation=1)
    step = test[0]["poses"][1][:3, 3] - test[0]["poses"][0][:3, 3]
    assert abs(step[2] - gen.STEP) < 1e-4
