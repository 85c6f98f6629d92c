"""Process-group bring-up and rank helpers (counterpart of
``aloception_tpu/parallel/distributed.py``), over ``torch.distributed``.

The reference's distributed story is Lightning DDP over NCCL
(``alonet/common/pl_helpers.py:365-374``); the JAX package brings up
``jax.distributed`` instead. Here ``init_multihost`` starts the default
process group: NCCL when the process trains on a card, gloo when the caller
asked for the CPU. Every process then binds ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Optional

import torch
import torch.distributed as dist

# how long a collective (and the rendezvous) may wait before the process
# group raises: a rank that died never leaves the others waiting for ever
TIMEOUT = datetime.timedelta(minutes=10)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: Optional[str] = None,
                   backend: Optional[str] = None) -> bool:
    """Start the default process group from explicit arguments or the
    environment, as the JAX package's ``init_multihost`` does:

    - ``ALO_COORDINATOR_ADDRESS`` (host:port of process 0, or a full
      ``tcp://`` / ``file://`` init method), ``ALO_NUM_PROCESSES`` and
      ``ALO_PROCESS_ID``; a coordinator without the other two raises
      ``ValueError``;
    - otherwise torchrun's ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE``, the
      counterpart of the JAX package's TPU-pod auto-detect.

    ``device`` "cpu" selects gloo; any other (the card by default) NCCL, and
    the process binds ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the
    environment, else the rank modulo the cards present). ``backend``
    overrides the choice (gloo also reduces CUDA tensors). Returns True when
    a group was started, False when nothing is configured (a single process)
    or a group already exists."""
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("ALO_COORDINATOR_ADDRESS"))
    if num_processes is None and env.get("ALO_NUM_PROCESSES"):
        num_processes = int(env["ALO_NUM_PROCESSES"])
    if process_id is None and env.get("ALO_PROCESS_ID"):
        process_id = int(env["ALO_PROCESS_ID"])

    if is_initialized():
        return False

    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "init_multihost: ALO_COORDINATOR_ADDRESS set but "
                "ALO_NUM_PROCESSES / ALO_PROCESS_ID missing")
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        rank, world = process_id, num_processes
    elif env.get("MASTER_ADDR") and env.get("RANK") \
            and env.get("WORLD_SIZE"):
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        return False

    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: no CUDA card; pass "
                               "device='cpu' to run the group on gloo")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method=init_method, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_device_count() -> int:
    """The cards this process sees (0 on a machine without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_main_process() -> bool:
    """The rank-0 gate for logging and checkpoint writes."""
    return process_index() == 0


def main_process_only(fn):
    """Decorator: run only on process 0, return None elsewhere."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None
    return wrapper


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (itself without a group)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
