"""Multi-process runtime: the ``torch.distributed`` process group and the
process topology (port of ``icek_tpu/parallel/distributed.py``).

The JAX package runs one process per host over all of its devices; the
port runs one process per card, as PyTorch does: every rank calls
:func:`maybe_initialize` before it touches a card, its loader reads its
own slice of every global batch (``process_index`` / ``process_count``
through ``icek_torch/data``), and the collectives of ``parallel/mesh.py``
join the slices.

Process topology is taken from, in order:
  1. explicit arguments,
  2. the ``ICEK_COORDINATOR`` (``host:port``) / ``ICEK_NUM_PROCESSES`` /
     ``ICEK_PROCESS_ID`` environment variables, one process per card,
  3. the launcher environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
     ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the counterpart of
     JAX's cluster auto-detection.

The backend is NCCL for ``device="cuda"`` and gloo for ``device="cpu"``;
a run that asked for the card never falls back to gloo.  Each rank of a
CUDA group uses card ``LOCAL_RANK`` (else its process id modulo the cards
it sees).  Single-process runs skip initialization: calling
:func:`maybe_initialize` is always safe.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    index: int
    count: int

    @property
    def is_primary(self) -> bool:
        return self.index == 0


def backend_for(device) -> str:
    """NCCL on CUDA, gloo on the CPU; raises for a CUDA run without a card."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed: device 'cuda' requested but no CUDA device "
                               "is available; pass device='cpu' for a gloo group")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"distributed: no backend for device {device!r}")


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's card: ``LOCAL_RANK`` when the launcher set it, else
    the process id modulo the cards this process sees."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    pid = process_id if process_id is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    return pid % max(torch.cuda.device_count(), 1)


def _init(backend: str, init_method: str, world_size: int, rank: int) -> None:
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    force: bool = False,
    device="cuda",
) -> ProcessInfo:
    """Initialize the default process group when a multi-process topology
    is configured; no-op otherwise.  Idempotent.  Returns the live process
    topology either way (so callers can shard loaders unconditionally).

    ``force=True`` (the apps' ``--distributed`` flag) initializes from the
    launcher environment when no ``ICEK_*`` topology is given, and raises if
    there is none, because a user who asked for distributed must never
    silently get N independent single-process replicas clobbering each
    other."""
    if dist.is_available() and dist.is_initialized():
        return process_info()
    coordinator_address = coordinator_address or os.environ.get("ICEK_COORDINATOR")
    env_np = os.environ.get("ICEK_NUM_PROCESSES")
    env_pid = os.environ.get("ICEK_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    launcher = all(v in os.environ for v in _TORCHRUN_VARS)

    explicit = coordinator_address is not None or num_processes is not None
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "distributed: an explicit topology needs all of ICEK_COORDINATOR "
                f"(got {coordinator_address!r}), ICEK_NUM_PROCESSES ({num_processes!r}) "
                f"and ICEK_PROCESS_ID ({process_id!r})")
        if num_processes > 1 or force:
            _init(backend_for(device), f"tcp://{coordinator_address}", num_processes,
                  process_id)
        return process_info()
    if launcher and (force or int(os.environ["WORLD_SIZE"]) > 1):
        _init(backend_for(device), "env://", int(os.environ["WORLD_SIZE"]),
              int(os.environ["RANK"]))
        return process_info()
    if force:
        # force=True with nothing to detect: fail loudly instead of quietly
        # degrading to an unsharded single-process run
        raise RuntimeError(
            "--distributed was requested but no multi-process topology "
            "was found: set ICEK_COORDINATOR/ICEK_NUM_PROCESSES/"
            "ICEK_PROCESS_ID (or run under torchrun, which sets RANK/"
            "WORLD_SIZE/MASTER_ADDR/MASTER_PORT)")
    return process_info()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_initialized(device="cuda") -> ProcessInfo:
    """The live topology; a single-rank group on localhost when no group
    exists yet (a mesh of one process)."""
    if not dist.is_initialized():
        _init(backend_for(device), f"tcp://localhost:{free_port()}", 1, 0)
    return process_info()


def device_type() -> str:
    """"cuda" for an NCCL default group, "cpu" for gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def process_info() -> ProcessInfo:
    if dist.is_available() and dist.is_initialized():
        return ProcessInfo(dist.get_rank(), dist.get_world_size())
    return ProcessInfo(0, 1)


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def local_batch_size(global_batch_size: int, count: Optional[int] = None) -> int:
    """Rows of each global batch this process loads.  The global batch size
    must divide evenly: a ragged final process would desynchronize the
    collectives."""
    count = process_info().count if count is None else count
    if global_batch_size % count:
        raise ValueError(
            f"global batch size {global_batch_size} is not divisible by "
            f"process count {count}"
        )
    return global_batch_size // count
