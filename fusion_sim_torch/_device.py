"""The device rule shared by every entry point of the port."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; with no CUDA device this raises instead
    of falling back to the CPU.  Callers that want the CPU (the tests)
    pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def device_const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant of ``values`` on ``device``, made once (a copy to
    the card waits for its queue); callers never write to it."""
    return _const(tuple(values), torch.device(device), dtype)


@functools.lru_cache(maxsize=256)
def _const(values: tuple, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (the timing fence of the benches:
    PyTorch returns before the card finishes).  A no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``) or ``'cpu'``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
