"""Rank bodies of the port's multi-rank CPU tests
(tests/test_torch_multidevice_equiv.py, test_torch_multidevice_eval.py,
test_torch_topology_resume.py), started by
`behindthescenes_tpu_torch.parallel.launch.run_ranks` over gloo. This
module imports torch, numpy and the port only, so that a spawned rank
never loads JAX; the tests compute the 1-rank and JAX references in their
own process."""
import copy

import numpy as np
import torch

from behindthescenes_tpu_torch.parallel import mesh
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.training.wrapper import draw_rows
from behindthescenes_tpu_torch.weights import (flat_from_state_dict,
                                               state_dict_from_flat)


def make_trainer(conf: dict, flat: dict) -> BTSTrainer:
    """An f32 trainer on the CPU from the Flax-keyed variables `flat`,
    with a fresh Adam and accumulator."""
    trainer = BTSTrainer(conf, compute_dtype=torch.float32, device="cpu")
    trainer.init_state()
    trainer.net.load_state_dict(state_dict_from_flat(flat))
    return trainer


def step_result(trainer: BTSTrainer, batch: dict, draws=None) -> dict:
    """One train step: its loss terms, the (reduced) gradient, and the
    parameters and BatchNorm statistics after the update, by Flax key."""
    terms = trainer.train_step(batch, draws)
    grads = flat_from_state_dict({n: p.grad for n, p in
                                  trainer.net.named_parameters()
                                  if p.grad is not None})
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": grads,
            "state": flat_from_state_dict(trainer.net.state_dict())}


def train_steps_rank(rank, world, conf, flat, batch, draws):
    """Two fresh trainers' first steps on this rank's rows of the global
    batch: with this rank's rows of `draws` (the JAX step's, replayed),
    and with the trainers' own generator (which draws the global batch's
    values)."""
    group = mesh.default_group()
    local = mesh.shard_batch(batch, group)
    n = batch["imgs"].shape[0] // world
    replayed = step_result(make_trainer(conf, flat), local,
                           draw_rows(draws, rank * n, (rank + 1) * n))
    generated = step_result(make_trainer(conf, flat), local)
    return {"replayed": replayed, "generated": generated}


def micro_steps_rank(rank, world, conf, flat, batch, steps):
    """`steps` micro-steps of one trainer on this rank's rows of the global
    batch, the draws from its own generator. Returns the trainer's state
    (parameters, statistics, Adam, accumulator, counters) by name."""
    trainer = make_trainer(conf, flat)
    local = mesh.shard_batch(batch, mesh.default_group())
    for _ in range(steps):
        trainer.train_step(local)
    return {"net": flat_from_state_dict(trainer.net.state_dict()),
            "updates": trainer.updates, "mini_step": trainer.mini_step}


def save_after_step_rank(rank, world, conf, flat, batch, directory):
    """A step of the global batch, then the checkpoint (rank 0 writes).
    Returns the trainer's state after the step."""
    from behindthescenes_tpu_torch.training.harness import CheckpointManager
    trainer = make_trainer(conf, flat)
    trainer.train_step(mesh.shard_batch(batch, mesh.default_group()))
    if rank == 0:
        CheckpointManager(directory).save(trainer.step, trainer)
    mesh.barrier(mesh.default_group())
    return trainer.state_dict()


def resume_and_step_rank(rank, world, conf, flat, batch, directory):
    """Restore the latest checkpoint of `directory` into a fresh trainer,
    then a step of the global batch. Returns the restored state and the
    step's loss terms."""
    from behindthescenes_tpu_torch.training.harness import CheckpointManager
    trainer = make_trainer(conf, flat)
    step, _ = CheckpointManager(directory).restore(trainer)
    restored = {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in trainer.net.state_dict().items()}
    restored = {"net": restored, "step": step,
                "optimizer": copy.deepcopy(trainer.optimizer.state_dict())}
    res = step_result(trainer, mesh.shard_batch(batch, mesh.default_group()))
    return {"restored": restored, "terms": res["terms"]}


def as_numpy(tree):
    """Tensors of nested dicts as numpy arrays."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def np_batch(h: int, w: int, n: int, v: int = 3, seed: int = 3) -> dict:
    """The JAX multi-device tests' batch (tests/test_multidevice_equiv.py
    `_batch`): uniform images, identity poses with the other views 0.5 to
    the side, one intrinsic matrix."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (n, v, h, w, 3)).astype(np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (n, v, 4, 4)).copy()
    poses[:, 1:, 0, 3] = 0.5
    projs = np.broadcast_to(
        np.array([[0.6, 0, 0], [0, 1.8, 0], [0, 0, 1]], dtype=np.float32),
        (n, v, 3, 3)).copy()
    return {"imgs": images, "poses": poses, "projs": projs}


def eval_model_conf() -> dict:
    """tests/test_multidevice_eval.py's model: ResNet-18 monodepth2,
    16-channel latents, ResnetFC width 32, z code."""
    return {
        "arch": "BTSNet", "z_near": 3.0, "z_far": 80.0, "inv_z": True,
        "code_mode": "z", "learn_empty": False,
        "code": {"num_freqs": 4, "freq_factor": 1.5, "include_input": True},
        "encoder": {"type": "monodepth2", "resnet_layers": 18,
                    "num_ch_dec": [16, 16, 32, 32, 64], "d_out": 16},
        "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 32},
        "mlp_fine": {"type": "empty"},
    }


def eval_net(seed: int = 0):
    """The eval tests' net on the CPU in f32 eval mode, from the port's
    initialiser seeded with `seed`."""
    from behindthescenes_tpu_torch.models.bts import BTSNet
    from behindthescenes_tpu_torch.training.trainer import init_params
    net = BTSNet.from_conf(eval_model_conf(), compute_dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(seed)
    init_params(net, gen)
    return net.eval()


def eval_batch(h: int, w: int) -> dict:
    """tests/test_multidevice_eval.py's item: 2 views, the second 0.5 to
    the side, and a depth map drawn in [3, 30)."""
    rng = np.random.default_rng(4)
    batch = np_batch(h, w, 1, v=2, seed=4)
    batch["depths"] = rng.uniform(3.0, 30.0, (1, 1, h, w)).astype(np.float32)
    return batch


def _generator(seed: int):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


@torch.no_grad()
def evaluations(group=None, hw=(32, 48), frame_hw=(15, 21), n_points=3777,
                query_batch_size=256) -> dict:
    """What tests/test_multidevice_eval.py renders, through the port's
    evaluators and renderer on `group` (None: one rank): the general-path
    depth metrics, the NVS metrics, the renders of a frame whose ray count
    does not divide the ranks (one chunk, many chunks, and with a fine
    pass), the occupancy query of `n_points` points, and two sweep frames
    (warp 0.5 and exact)."""
    from behindthescenes_tpu_torch import geometry
    from behindthescenes_tpu_torch import renderer as R
    from behindthescenes_tpu_torch.evaluation.bbox_occ import \
        BBoxOccEvaluator
    from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
    from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator
    from behindthescenes_tpu_torch.models.sweep import render_frame_sweep
    from behindthescenes_tpu_torch.ray_sampler import ImageRaySampler

    net = eval_net()
    mc = eval_model_conf()
    cfg = R.RendererConfig(n_coarse=8, lindisp=True, hard_alpha_cap=True)
    batch = eval_batch(*hw)
    out = {}
    ev = DepthEvaluator(net, cfg, dict(mc, eval_selfview=False))
    out["depth_group"] = ev.group is not None
    out["depth"] = ev.evaluate(batch, generator=_generator(1))
    nvs = NVSEvaluator(net, cfg, mc)
    out["nvs_group"] = nvs.group is not None
    out["nvs"] = nvs.evaluate(batch, generator=_generator(2))

    imgs = torch.as_tensor(batch["imgs"])
    projs = torch.as_tensor(batch["projs"])
    poses = torch.as_tensor(batch["poses"])
    grid = net.encode(imgs, projs, poses, ids_encoder=[0], ids_render=[0])
    sampler = ImageRaySampler(3.0, 80.0, height=frame_hw[0],
                              width=frame_hw[1])
    rays, _ = sampler.sample(None, poses[:, :1], projs[:, :1])

    def query_fn(xyz, coarse):
        return net.query(grid, xyz, coarse=coarse)
    fine = R.RendererConfig(n_coarse=8, n_fine=4, n_fine_depth=2,
                            lindisp=True, hard_alpha_cap=True)
    for name, rcfg, chunk in (("frame", cfg, 16384),
                              ("frame_chunks", cfg, 40),
                              ("frame_fine", fine, 64)):
        out[name] = as_numpy(R.render_rays_chunked(
            query_fn, rays, rcfg, ray_chunk=chunk, generator=_generator(3),
            group=group, want_weights=True, want_alphas=True,
            want_z_samps=True))

    rng = np.random.default_rng(7)
    pts = (rng.uniform(-1, 1, (n_points, 3)) * np.array([4, 1, 8])
           + np.array([0, 0, 10.0])).astype(np.float32)
    occ = BBoxOccEvaluator(net, cfg, dict(mc, query_batch_size=
                                          query_batch_size), dataset=None)
    out["occ_group"] = occ.group is not None
    out["sigmas"] = occ.query_density(grid, pts)

    poses_r = geometry.rebase_poses_to_keyframe(poses)
    grid_s = net.encode(imgs, projs, poses_r, ids_encoder=[0],
                        ids_render=[0], images_alt=imgs[:, :1] * 0.5 + 0.5)
    for name, warp in (("sweep", 0.5), ("sweep_exact", None)):
        out[name] = as_numpy(render_frame_sweep(
            net, grid_s, poses_r[0, 1], projs[0, 1], hw, cfg,
            warp_scale=warp, group=group)["coarse"])
    return out


def evaluations_rank(rank, world, kwargs):
    """`evaluations` on the launcher's group."""
    return evaluations(mesh.default_group(), **kwargs)


def failing_rank(rank, world):
    """Rank 1 raises; rank 0 waits for it in a collective it never
    joins."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier(mesh.default_group())


def sleeping_rank(rank, world, seconds):
    """Every rank outlasts the launcher's timeout."""
    import time
    time.sleep(seconds)
