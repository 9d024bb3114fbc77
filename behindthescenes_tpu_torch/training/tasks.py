"""Training tasks: dataflow and harness glue per workload (counterpart of
behindthescenes_tpu/training/tasks.py:14-127; reference
models/bts/trainer.py:355-427 and trainer_overfit.py:72-208)."""
from __future__ import annotations

import copy
import os

from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.loader import (DataLoader,
                                                      shard_for_host,
                                                      split_for_rank)
from behindthescenes_tpu_torch.training.harness import base_training
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.training.visualize import make_tb_visualizer


def bts_get_dataflow(config):
    """(train, validation, visualisation) loaders (reference
    models/bts/trainer.py:359-392): the training set shuffled by the
    config's seed with the last partial batch dropped; the test set with
    `eval_frame_count` frames and depth, at most 256 items; its first
    item for the visualisation. With `data.host_shard` (rank, world) the
    training loader reads the rank's `shard_for_host` (in place of
    DistributedSampler) and the validation loader its share of the test
    items, the shares covering every item."""
    train_ds, test_ds = make_datasets(config["data"])
    host_shard = config["data"].get("host_shard")
    if host_shard:
        train_ds = shard_for_host(train_ds, *host_shard)

    test_ds = copy.copy(test_ds)
    if hasattr(test_ds, "frame_count"):
        test_ds.frame_count = config["data"].get("eval_frame_count", 2)
    if hasattr(test_ds, "return_depth"):
        test_ds.return_depth = True
    if hasattr(test_ds, "length"):
        test_ds.length = min(getattr(test_ds, "length", 256), 256)

    vis_ds = copy.copy(test_ds)
    if hasattr(vis_ds, "length"):
        vis_ds.length = 1
    val_ds = split_for_rank(test_ds, *host_shard) if host_shard else test_ds

    nw = config.get("num_workers", 2)
    train_loader = DataLoader(train_ds, batch_size=config["batch_size"],
                              shuffle=True, drop_last=True, num_workers=nw,
                              seed=config.get("seed", 0))
    test_loader = DataLoader(val_ds, batch_size=1, num_workers=nw)
    vis_loader = DataLoader(vis_ds, batch_size=1, num_workers=0)
    return train_loader, test_loader, vis_loader


def _tensorboard(config):
    """A SummaryWriter under <output_path>/tb, or None where the config
    turns it off or torch.utils.tensorboard cannot be imported."""
    if not config.get("tensorboard", True):
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(config.get("output_path", "out/run"),
                                      "tb"))


def bts_training(config, device=None, mark=None, on_iteration=None):
    """The BTS training run of `config` through the harness, with train and
    validation scalars and the visualisation grids
    (training/visualize.py, every `visualize_every` iterations) in
    TensorBoard where it is importable. Returns the trainer."""
    trainer = BTSTrainer(config, device=device)
    # Rank 0 alone writes the scalars and the grids.
    writer = _tensorboard(config) if trainer.rank == 0 else None
    visualize = make_tb_visualizer(writer) if writer is not None else None
    log_tb_every = config.get("log_tb_train_every_iters", 50)

    def iteration(it, trainer, loss_dict):
        if writer is not None and log_tb_every > 0 and \
                it % log_tb_every == 0:
            for k, v in loss_dict.items():
                writer.add_scalar(f"train/{k}", float(v), global_step=it)
        if on_iteration is not None:
            on_iteration(it, trainer, loss_dict)

    def on_validation(it, metrics):
        if writer is not None:
            for k, v in metrics.items():
                writer.add_scalar(f"val/{k}", float(v), global_step=it)

    try:
        return base_training(config, bts_get_dataflow, trainer=trainer,
                             visualize=visualize, on_iteration=iteration,
                             on_validation=on_validation, mark=mark)
    finally:
        if writer is not None:
            writer.close()


class _CachedBatchLoader:
    """One collated batch, repeated: the overfit dataflow (reference
    trainer_overfit.py:36-59)."""

    def __init__(self, batch, iters_per_epoch: int):
        self.batch = batch
        self.iters = iters_per_epoch

    def __len__(self):
        return self.iters

    def __iter__(self):
        for _ in range(self.iters):
            yield self.batch

    def set_epoch(self, epoch):
        pass


def bts_overfit_training(config, device=None):
    """The overfit workload: the learned map in place of the CNN and one
    cached batch (reference trainer_overfit.py:62-208). Returns the
    trainer."""
    train_ds, _ = make_datasets(config["data"])
    batch = next(iter(DataLoader(train_ds,
                                 batch_size=config.get("batch_size", 1),
                                 num_workers=0)))
    h, w = batch["imgs"].shape[2:4]
    config = copy.deepcopy(config)
    config["model_conf"]["encoder"] = {
        "type": "dummy", "size": (h, w),
        "d_out": config["model_conf"]["encoder"].get("d_out", 64)}
    config["model_conf"]["flip_augmentation"] = False
    loader = _CachedBatchLoader(batch, config.get("num_iters_per_epoch", 100))
    trainer = BTSTrainer(config, device=device)
    return base_training(config, lambda _: (loader, None, None),
                         trainer=trainer)
