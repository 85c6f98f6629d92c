"""RAFT optical flow, inference (counterpart of
``aloception_tpu/models/raft``; the criterion waits in ROADMAP A7)."""
from .raft import (RAFT, RAFTBase, built, convex_upsample,  # noqa: F401
                   inference, raft, raft_small, upflow8)
from .utils import Padder  # noqa: F401
from .extractor import BasicEncoder, SmallEncoder  # noqa: F401
