"""Starting the process group (counterpart of dist/multihost.py).

Every process of a launch calls `initialize` first:

    from mitsuba2_tpu_torch.dist import multihost, sharding
    multihost.initialize()                  # torchrun's environment
    mesh = multihost.pod_mesh()             # every rank, its own card
    img = sharding.render_sharded(scene, config, mesh)

Under `torchrun --nproc-per-node=N` a bare call reads RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; explicit arguments name the
coordinator (host:port), the number of processes and this one's rank.
The backend is NCCL where CUDA is available and gloo otherwise, unless
the caller names one. NCCL drives one card a rank: two ranks on one card
fail its handshake ("Duplicate GPU detected"), so `initialize` refuses
NCCL with more ranks on a host than cards and names gloo, which
all-reduces CUDA tensors through the host; it never picks gloo itself.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def _already_initialized() -> bool:
    """Has the default process group been made in this process?"""
    return dist.is_available() and dist.is_initialized()


def _env_int(name):
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def _ranks_on_host(address, world):
    """The ranks a launch puts on this host: torchrun's
    LOCAL_WORLD_SIZE, else all of them where the coordinator is this
    host, else unknown (None)."""
    local = _env_int("LOCAL_WORLD_SIZE")
    if local is not None:
        return local
    if address and address.rsplit(":", 1)[0].strip("[]") in _LOCAL_HOSTS:
        return world
    return None


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, backend: str = None) -> None:
    """torch.distributed.init_process_group from explicit arguments or
    torchrun's environment. Idempotent. A bare call with no such
    environment runs standalone (no group); otherwise a failed handshake
    raises: a misconfigured launch must surface, not render one rank's
    share of the film."""
    if _already_initialized():
        return
    explicit = any(a is not None for a in (coordinator_address,
                                           num_processes, process_id))
    address = coordinator_address
    if address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if not explicit and world is None and rank is None:
        return      # no launch around this process: standalone
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and world is not None:
        on_host = _ranks_on_host(address, world)
        cards = torch.cuda.device_count()
        if on_host is not None and on_host > cards:
            raise RuntimeError(
                f"{on_host} ranks on a host with {cards} CUDA device(s): "
                "NCCL runs one rank a card; pass backend='gloo' to run "
                "several ranks on one card")
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK; else its
    global rank, 0 standalone)."""
    v = _env_int("LOCAL_RANK")
    if v is not None:
        return v
    return dist.get_rank() if _already_initialized() else 0


def rank_device() -> torch.device:
    """This rank's card, cuda:{LOCAL_RANK % device_count}; raises
    without CUDA (a rank on the CPU passes device="cpu" to pod_mesh)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def pod_mesh(device=None):
    """The mesh of every rank of the default group (world size 1
    standalone), on `device` (None = this rank's card, rank_device())."""
    from .sharding import make_mesh
    return make_mesh(device=rank_device() if device is None else device)


def is_coordinator() -> bool:
    """True on the rank that does the I/O (progress, checkpoints,
    images): rank 0, or a process with no group."""
    return not _already_initialized() or dist.get_rank() == 0
