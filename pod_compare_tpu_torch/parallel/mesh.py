"""Processes, ranks, and what each process holds of the data.

Counterpart of ``pod_compare_tpu/parallel/mesh.py`` (kept under the JAX
file's name). The JAX package runs one controller over a mesh of devices;
the port runs one process per card under ``torch.distributed``, as the
reference does through detectron2's ``launch`` (reference
``train_net.py:91-98``). ``launch`` spawns those processes on one machine;
``torchrun``, or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, starts them on one machine or several, and
``maybe_initialize_distributed`` joins them into a process group.

Each process holds a shard of the data: in evaluation a strided shard of
the test set, whose json results ``gather_process_results`` gathers in
rank order; in training the rows ``BatchShard`` names of each global
batch, with the gradients summed by ``DistributedDataParallel``. The
backend is NCCL on CUDA and gloo on the CPU. NCCL refuses two processes on
one card, so such a run (a test of the multi-process path on a one-card
machine) must ask for gloo; nothing falls back to it.

Ensembles place their members instead: ``create_ensemble_placement`` gives
each member model a card of this process, the counterpart of the member
axis of ``create_ensemble_mesh``.
"""

import datetime
import os
import pickle
import socket
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
COLLECTIVE_TIMEOUT_S = 1800.0
_device: Optional[torch.device] = None  # the device this process was initialised on


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    """Rank 0, the process that writes (reference: comm.is_main_process(),
    train_net.py:74)."""
    return process_index() == 0


def local_device(device=None) -> Optional[torch.device]:
    """`device` when the caller names one; else the device
    ``maybe_initialize_distributed`` gave this process; else cuda:LOCAL_RANK
    under a launcher; else None, which the entry points read as CUDA."""
    if device is not None:
        return torch.device(device)
    if _device is not None:
        return _device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return None


def maybe_initialize_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join the process group a launcher set up in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as ``torchrun`` and
    ``launch`` set them); True when this call initialised it. A no-op
    without those variables or when the group exists already.

    The process runs on `device`, default cuda:LOCAL_RANK, which becomes
    the current CUDA device (raising without CUDA: there is no fallback).
    `backend` defaults to NCCL on CUDA and gloo on the CPU."""
    global _device
    if _initialized() or any(v not in os.environ for v in _LAUNCHER_VARIABLES):
        return False
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://",
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    _device = dev
    return True


def gather_process_results(results: list) -> list:
    """Every process's list, concatenated in rank order, on every process;
    the list itself on one process. Collective: every rank calls it.

    The counterpart of the JAX package's gather (and of detectron2's
    ``comm.gather`` in the reference's COCOEvaluator), through
    ``all_gather_object``."""
    if process_count() == 1:
        return results
    parts = [None] * process_count()
    dist.all_gather_object(parts, results)
    return [r for part in parts for r in part]


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` summed over the processes, in place; itself on one process."""
    if process_count() > 1:
        dist.all_reduce(tensor)
    return tensor


def barrier() -> None:
    """Wait for every process; nothing on one process."""
    if process_count() > 1:
        dist.barrier()


@dataclass(frozen=True)
class BatchShard:
    """Rows [first, first + size) of a global batch of `total` rows: what one
    process holds of a data-parallel step. The random streams of a step
    (the dropout kernel's per-sample masks, the stochastic focal loss's
    draws) are keyed by the global row, so W processes draw what one process
    draws for the whole batch."""

    first: int
    size: int
    total: int

    @classmethod
    def of(cls, global_batch: int, index: Optional[int] = None,
           count: Optional[int] = None) -> "BatchShard":
        """Process `index`'s rows of `global_batch` split evenly over
        `count` processes (default: this process of the group); a batch that
        does not divide raises, as the JAX trainer requires a batch divisible
        by the training mesh."""
        index = process_index() if index is None else index
        count = process_count() if count is None else count
        if global_batch % count:
            raise ValueError(f"a batch of {global_batch} images does not divide over "
                             f"{count} processes")
        size = global_batch // count
        return cls(index * size, size, global_batch)

    @property
    def whole(self) -> bool:
        return self.size == self.total


def resolve_num_devices(num_devices: int, device=None) -> int:
    """The number of processes ``--num-devices`` asks for: N, or with -1 one
    per local card (one on the CPU). Asking for more cards than
    ``torch.cuda.device_count()`` raises and names both numbers; processes
    pinned to one named card (``cuda:0``) may share it."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if num_devices != -1 and num_devices < 1:
        raise ValueError(f"--num-devices {num_devices}: give -1 (every local card) or N >= 1")
    if dev.type != "cuda":
        return 1 if num_devices == -1 else num_devices
    have = torch.cuda.device_count()
    wanted = have if num_devices == -1 else num_devices
    if dev.index is None and (wanted > have or wanted < 1):
        raise ValueError(f"--num-devices {num_devices} asks for {wanted} CUDA devices, but "
                         f"torch.cuda.device_count() is {have}")
    return wanted


def check_process_count(num_devices: int) -> None:
    """Raise when PARALLEL.NUM_DEVICES (``--num-devices``) asks for another
    number of processes than this run has: the processes come from
    ``launch`` or a launcher, and the config only records them."""
    if num_devices not in (-1, process_count()):
        raise ValueError(f"PARALLEL.NUM_DEVICES {num_devices} asks for {num_devices} processes, "
                         f"but this run has {process_count()}: start them with --num-devices "
                         "or torchrun")


def _free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, count, port, device, backend, main_fn, args, out_dir):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(count),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    maybe_initialize_distributed(device if device is not None else f"cuda:{rank}", backend)
    try:
        result = main_fn(*args)
        if rank == 0:
            with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(main_fn: Callable, num_devices: int, args: Sequence = (), device=None,
           backend: Optional[str] = None, timeout_s: Optional[float] = None):
    """Run ``main_fn(*args)`` in one spawned process per card, joined in a
    process group on a free localhost port, and return rank 0's result.

    `num_devices` as ``resolve_num_devices`` reads it. Rank r runs on
    cuda:r, or every rank on `device` when it is given ('cpu'; or one card,
    with backend='gloo'). `main_fn` and `args` must pickle (a module-level
    function). If a rank raises, the others are stopped and the launch
    raises ``torch.multiprocessing``'s ``ProcessRaisedException``, which
    names the rank and carries its traceback; after `timeout_s` seconds the
    processes are killed and it raises TimeoutError."""
    count = resolve_num_devices(num_devices, device)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as out_dir:
        context = torch.multiprocessing.spawn(
            _rank_main, nprocs=count, join=False,
            args=(count, _free_port(), device, backend, main_fn, tuple(args), out_dir),
        )
        try:
            while not context.join(None if deadline is None
                                   else max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"launch: {count} processes still running after "
                                       f"{timeout_s} s")
        finally:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(os.path.join(out_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)


def create_ensemble_placement(num_members: int, devices=None) -> List[torch.device]:
    """The device of each ensemble member: member m on devices[m % D]
    (default: every local card), so that with as many cards as members each
    member runs on its own, and on one card every member shares it. The
    counterpart of ``create_ensemble_mesh``'s member axis."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError("create_ensemble_placement: no CUDA device; name the devices")
    if num_members < 1:
        raise ValueError(f"an ensemble needs members, got {num_members}")
    return [torch.device(devices[m % len(devices)]) for m in range(num_members)]
