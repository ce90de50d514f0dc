"""More than one process: one process per card under ``torch.distributed``."""

from pod_compare_tpu_torch.parallel.mesh import (
    BatchShard,
    all_reduce_sum,
    barrier,
    check_process_count,
    create_ensemble_placement,
    gather_process_results,
    is_main_process,
    launch,
    local_device,
    maybe_initialize_distributed,
    process_count,
    process_index,
    resolve_num_devices,
)

__all__ = [
    "BatchShard",
    "all_reduce_sum",
    "barrier",
    "check_process_count",
    "create_ensemble_placement",
    "gather_process_results",
    "is_main_process",
    "launch",
    "local_device",
    "maybe_initialize_distributed",
    "process_count",
    "process_index",
    "resolve_num_devices",
]
