"""Dataset factory (counterpart of behindthescenes_tpu/datasets/factory.py:
12-60): the Synthetic type, over the port's copy of the synthetic scenes,
and the disk datasets KITTI_Raw, KITTI_360, RealEstate10k,
KITTI_Odometry, Waymo and NYU_Depth_V2 (a test set only)."""
from __future__ import annotations

from behindthescenes_tpu_torch.datasets import synthetic
from behindthescenes_tpu_torch.datasets.synthetic import SyntheticBoxDataset


def make_datasets(data_conf: dict):
    """-> (train_dataset, test_dataset). Synthetic: the training set's
    items hold data_fc + 2 frames and no depth; the test set's hold 2
    frames and depth."""
    dtype = data_conf["type"]
    if dtype == "KITTI_360":
        from behindthescenes_tpu_torch.datasets.kitti_360 import (
            Kitti360Dataset)
        return Kitti360Dataset.make_train_test(data_conf)
    if dtype == "KITTI_Raw":
        from behindthescenes_tpu_torch.datasets.kitti_raw import (
            KittiRawDataset)
        return KittiRawDataset.make_train_test(data_conf)
    if dtype == "RealEstate10k":
        from behindthescenes_tpu_torch.datasets.realestate10k import (
            RealEstate10kDataset)
        return RealEstate10kDataset.make_train_test(data_conf)
    if dtype == "KITTI_Odometry":
        from behindthescenes_tpu_torch.datasets.kitti_odom import (
            KittiOdometryDataset)
        return KittiOdometryDataset.make_train_test(data_conf)
    if dtype == "Waymo":
        from behindthescenes_tpu_torch.datasets.waymo import WaymoDataset
        return WaymoDataset.make_train_test(data_conf)
    if dtype == "NYU_Depth_V2":
        from behindthescenes_tpu_torch.datasets.nyu_depth_v2 import (
            NYUDepthV2Dataset)
        return None, NYUDepthV2Dataset.make_test(data_conf)
    if dtype != "Synthetic":
        raise NotImplementedError(f"Unsupported dataset type: {dtype}")
    h, w = data_conf.get("image_size", (48, 64))
    fc = data_conf.get("data_fc", 2)
    length = data_conf.get("length", 64)
    scene = data_conf.get("scene", "street")
    thin = data_conf.get("thin_structures", 0)
    train = SyntheticBoxDataset(length=length, frame_count=fc + 2,
                                height=h, width=w, return_depth=False,
                                seed=1, scene_type=scene,
                                thin_structures=thin)
    return train, synthetic.make_test_dataset((h, w), length, scene, thin)


def make_test_dataset(data_conf: dict):
    """The test split of `make_datasets` (reference data_util.py:181-217).
    """
    return make_datasets(data_conf)[1]
