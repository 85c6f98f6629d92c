"""Datasets and transforms (counterpart of ``aloception_tpu/alodataset``):
the base dataset and its threaded loaders, the 26 transforms, COCO
detection, COCO panoptic and LVIS, merge and from-directory datasets, the
flow datasets (Sintel, FlyingChairs2, FlyingThings3D subset, ChairsSDHom),
the KITTI family and Waymo with its TFRecord converter: on disk, and as
offline synthetic samples. KITTI, Waymo, FlyingThings3D and ChairsSDHom
load at their first use, as in the JAX package."""

from .base_dataset import BaseDataset, Split  # noqa: F401
from .mixins import SequenceMixin, SplitMixin  # noqa: F401
from . import transforms  # noqa: F401
from .coco_detection import (CocoBaseDataset,  # noqa: F401
                             CocoDetectionDataset)
from .coco_panoptic import CocoPanopticDataset, id2rgb, rgb2id  # noqa: F401
from .lvis import LvisDataset  # noqa: F401
from .merge_dataset import MergeDataset  # noqa: F401
from .from_directory import FromDirectoryDataset  # noqa: F401
from .flying_chairs2 import FlyingChairs2Dataset  # noqa: F401
from .sintel import (SintelBaseDataset, SintelDisparityDataset,  # noqa: F401
                     SintelFlowDataset, SintelMultiDataset)

# JAX package datasets that wait in ROADMAP's first item of A
NOT_PORTED = ("Mot17", "CrowdHumanDataset", "WooDScapeDataset",
              "WooDScapeSplitDataset")


def __getattr__(name):
    if name == "WaymoDataset":
        from .waymo import WaymoDataset
        return WaymoDataset
    if name.startswith("Kitti"):
        from . import kitti
        return getattr(kitti, name)
    if name in ("FlyingThings3DSubsetDataset", "ChairsSDHomDataset"):
        from . import flying_things
        return getattr(flying_things, name)
    if name in NOT_PORTED:
        raise AttributeError(f"{name} is not ported yet (ROADMAP A)")
    raise AttributeError(name)
