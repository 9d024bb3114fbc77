"""KITTI-360 semantic label table (public devkit spec; reference
datasets/kitti_360/labels.py:14-200), the port's own copy of
behindthescenes_tpu/datasets/kitti_360_labels.py. Stored as records keyed
by id with the fields the evaluators use: name, kittiId, trainId,
category, color.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Label:
    name: str
    id: int
    kittiId: int
    trainId: int
    category: str
    categoryId: int
    hasInstances: bool
    color: Tuple[int, int, int]


_RAW = [
    # name, id, kittiId, trainId, category, catId, hasInstances, color
    ("unlabeled", 0, -1, 255, "void", 0, False, (0, 0, 0)),
    ("ego vehicle", 1, -1, 255, "void", 0, False, (0, 0, 0)),
    ("rectification border", 2, -1, 255, "void", 0, False, (0, 0, 0)),
    ("out of roi", 3, -1, 255, "void", 0, False, (0, 0, 0)),
    ("static", 4, -1, 255, "void", 0, False, (0, 0, 0)),
    ("dynamic", 5, -1, 255, "void", 0, False, (111, 74, 0)),
    ("ground", 6, -1, 255, "void", 0, False, (81, 0, 81)),
    ("road", 7, 1, 0, "flat", 1, False, (128, 64, 128)),
    ("sidewalk", 8, 3, 1, "flat", 1, False, (244, 35, 232)),
    ("parking", 9, 2, 255, "flat", 1, False, (250, 170, 160)),
    ("rail track", 10, 10, 255, "flat", 1, False, (230, 150, 140)),
    ("building", 11, 11, 2, "construction", 2, True, (70, 70, 70)),
    ("wall", 12, 7, 3, "construction", 2, False, (102, 102, 156)),
    ("fence", 13, 8, 4, "construction", 2, False, (190, 153, 153)),
    ("guard rail", 14, 30, 255, "construction", 2, False, (180, 165, 180)),
    ("bridge", 15, 31, 255, "construction", 2, False, (150, 100, 100)),
    ("tunnel", 16, 32, 255, "construction", 2, False, (150, 120, 90)),
    ("pole", 17, 21, 5, "object", 3, True, (153, 153, 153)),
    ("polegroup", 18, -1, 255, "object", 3, False, (153, 153, 153)),
    ("traffic light", 19, 23, 6, "object", 3, True, (250, 170, 30)),
    ("traffic sign", 20, 24, 7, "object", 3, True, (220, 220, 0)),
    ("vegetation", 21, 5, 8, "nature", 4, False, (107, 142, 35)),
    ("terrain", 22, 4, 9, "nature", 4, False, (152, 251, 152)),
    ("sky", 23, 9, 10, "sky", 5, False, (70, 130, 180)),
    ("person", 24, 19, 11, "human", 6, True, (220, 20, 60)),
    ("rider", 25, 20, 12, "human", 6, True, (255, 0, 0)),
    ("car", 26, 13, 13, "vehicle", 7, True, (0, 0, 142)),
    ("truck", 27, 14, 14, "vehicle", 7, True, (0, 0, 70)),
    ("bus", 28, 34, 15, "vehicle", 7, True, (0, 60, 100)),
    ("caravan", 29, 16, 255, "vehicle", 7, True, (0, 0, 90)),
    ("trailer", 30, 15, 255, "vehicle", 7, True, (0, 0, 110)),
    ("train", 31, 33, 16, "vehicle", 7, True, (0, 80, 100)),
    ("motorcycle", 32, 17, 17, "vehicle", 7, True, (0, 0, 230)),
    ("bicycle", 33, 18, 18, "vehicle", 7, True, (119, 11, 32)),
    ("garage", 34, 12, 2, "construction", 2, True, (64, 128, 128)),
    ("gate", 35, 6, 4, "construction", 2, False, (190, 153, 153)),
    ("stop", 36, 29, 255, "construction", 2, True, (150, 120, 90)),
    ("smallpole", 37, 22, 5, "object", 3, True, (153, 153, 153)),
    ("lamp", 38, 25, 255, "object", 3, True, (0, 64, 64)),
    ("trash bin", 39, 26, 255, "object", 3, True, (0, 128, 192)),
    ("vending machine", 40, 27, 255, "object", 3, True, (128, 64, 0)),
    ("box", 41, 28, 255, "object", 3, True, (64, 64, 128)),
    ("unknown construction", 42, 35, 255, "void", 0, False, (102, 0, 0)),
    ("unknown vehicle", 43, 36, 255, "void", 0, False, (51, 0, 51)),
    ("unknown object", 44, 37, 255, "void", 0, False, (32, 32, 32)),
    ("license plate", -1, -1, -1, "vehicle", 7, False, (0, 0, 142)),
]

labels = [Label(n, i, k, t, cat, cid, inst, col)
          for n, i, k, t, cat, cid, inst, col in _RAW]
id2label: Dict[int, Label] = {l.id: l for l in labels}
name2label: Dict[str, Label] = {l.name: l for l in labels}
kittiId2label: Dict[int, Label] = {l.kittiId: l for l in labels
                                   if l.kittiId >= 0}
