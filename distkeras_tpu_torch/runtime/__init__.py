"""Run-time plumbing of the port: the typed environment registry and the
device rule every entry point follows."""

from distkeras_tpu_torch.runtime.device import resolve_device

__all__ = ["resolve_device"]
