"""RAFT optical flow (counterpart of ``aloception_tpu/models/raft``)."""
from .criterion import raft_sequence_loss  # noqa: F401
from .raft import (RAFT, RAFTBase, built, convex_upsample,  # noqa: F401
                   inference, raft, raft_small, upflow8)
from .utils import Padder  # noqa: F401
from .extractor import BasicEncoder, SmallEncoder  # noqa: F401
