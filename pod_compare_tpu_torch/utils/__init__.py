"""Framework-free utilities (logging, metric storage, TensorBoard event
files) and the device resolution every entry point shares."""

from pod_compare_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
