"""Frame-sample modes: which views encode, render, and receive loss (the
port's numpy-only copy of behindthescenes_tpu/training/view_select.py:17-143,
reference models/bts/trainer.py:114-196). Runs on the host each step and
draws from the numpy generator it is given, in the JAX package's order, so
the same seed picks the same views.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ViewIds:
    """View index arrays of one step, and the combine groups: view ids
    (combine_ids), or positions within the encoder and the render views
    (combine_encoder / combine_render, the waymo modes)."""
    ids_encoder: np.ndarray
    ids_render: np.ndarray
    ids_loss: np.ndarray
    combine_ids: Optional[Tuple[Tuple[int, ...], ...]] = None
    combine_encoder: Optional[Tuple[Tuple[int, ...], ...]] = None
    combine_render: Optional[Tuple[Tuple[int, ...], ...]] = None


def select_views(rng: np.random.Generator, v: int, frames_render: Sequence[int],
                 frame_sample_mode: str, training: bool,
                 loss_from_single_img: bool = False) -> ViewIds:
    ids_encoder = np.array([0], dtype=np.int32)
    combine_ids = None

    if training:
        frame_perm = rng.permutation(v)
    else:
        frame_perm = np.arange(v)

    ids_render = np.sort(
        frame_perm[[i for i in frames_render if i < v]]).astype(np.int32)

    if training:
        if frame_sample_mode == "only":
            ids_loss = np.array([0], dtype=np.int32)
            ids_render = ids_render[ids_render != 0]
        elif frame_sample_mode == "not":
            frame_perm = rng.permutation(v - 1) + 1
            ids_loss = np.sort(
                frame_perm[[i for i in frames_render if i < v - 1]]
            ).astype(np.int32)
            ids_render = np.array(
                [i for i in range(v) if i not in ids_loss], dtype=np.int32)
        elif frame_sample_mode == "stereo":
            if frame_perm[0] < v // 2:
                ids_loss = np.arange(v // 2, dtype=np.int32)
                ids_render = np.arange(v // 2, v, dtype=np.int32)
            else:
                ids_loss = np.arange(v // 2, v, dtype=np.int32)
                ids_render = np.arange(v // 2, dtype=np.int32)
        elif frame_sample_mode == "mono":
            split_i = v // 2
            if frame_perm[0] < v // 2:
                ids_loss = np.array(
                    list(range(0, split_i, 2)) + list(range(split_i + 1, v, 2)),
                    dtype=np.int32)
                ids_render = np.array(
                    list(range(1, split_i, 2)) + list(range(split_i, v, 2)),
                    dtype=np.int32)
            else:
                ids_loss = np.array(
                    list(range(1, split_i, 2)) + list(range(split_i, v, 2)),
                    dtype=np.int32)
                ids_render = np.array(
                    list(range(0, split_i, 2)) + list(range(split_i + 1, v, 2)),
                    dtype=np.int32)
        elif frame_sample_mode == "kitti360-mono":
            steps = v // 4
            start_from = 0 if frame_perm[0] < v // 2 else 1
            ids_loss, ids_render = [], []
            for cam in range(4):
                ids_loss += [cam * steps + i
                             for i in range(start_from, steps, 2)]
                ids_render += [cam * steps + i
                               for i in range(1 - start_from, steps, 2)]
                start_from = 1 - start_from
            ids_loss = np.array(ids_loss, dtype=np.int32)
            ids_render = np.array(ids_render, dtype=np.int32)
        elif frame_sample_mode.startswith("waymo"):
            num_views = int(frame_sample_mode.split("-")[-1])
            steps = v // num_views
            split = steps // 2
            ids_encoder = np.array([0, steps, steps * 2], dtype=np.int32)
            combine_ids = tuple(
                (i, steps + i, steps * 2 + i) for i in range(steps))
            step_perm = rng.permutation(steps).tolist()
            ids_loss = np.array(sum(
                [[i + j * steps for j in range(num_views)]
                 for i in step_perm[:split]], []), dtype=np.int32)
            ids_render = np.array(sum(
                [[i + j * steps for j in range(num_views)]
                 for i in step_perm[split:]], []), dtype=np.int32)
            # Positional combine groups are deterministic: ids_render is
            # laid out [i_k, i_k+steps, i_k+2*steps] per kept timestep k, so
            # render group k occupies positions (3k, 3k+1, 3k+2); only the
            # i=0 group intersects the encoder set and 0 may not be kept —
            # encoder combining at train time uses the single encoder view
            # per camera (positions 0..2).
            n_groups = steps - split
            combine_render = tuple(
                (3 * k, 3 * k + 1, 3 * k + 2) for k in range(n_groups))
            combine_encoder = ((0, 1, 2),)
            return ViewIds(ids_encoder=ids_encoder, ids_render=ids_render,
                           ids_loss=ids_loss, combine_ids=combine_ids,
                           combine_encoder=combine_encoder,
                           combine_render=combine_render)
        elif frame_sample_mode == "default":
            ids_loss = frame_perm[
                [i for i in range(v) if frame_perm[i] not in ids_render]
            ].astype(np.int32)
        else:
            raise NotImplementedError(frame_sample_mode)
    else:
        ids_loss = np.arange(v, dtype=np.int32)
        ids_render = np.array([0], dtype=np.int32)
        if frame_sample_mode.startswith("waymo"):
            num_views = int(frame_sample_mode.split("-")[-1])
            steps = v // num_views
            ids_encoder = np.array([0, steps, steps * 2], dtype=np.int32)
            ids_render = np.array([0, steps, steps * 2], dtype=np.int32)
            combine_ids = tuple(
                (i, steps + i, steps * 2 + i) for i in range(steps))

    if loss_from_single_img:
        ids_loss = ids_loss[:1]

    return ViewIds(ids_encoder=ids_encoder, ids_render=ids_render,
                   ids_loss=ids_loss, combine_ids=combine_ids)
