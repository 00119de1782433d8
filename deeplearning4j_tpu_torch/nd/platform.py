"""Device resolution for the port: CUDA unless the caller asks for the CPU.

Counterpart of `deeplearning4j_tpu/nd/platform.py`. The JAX package asks
the default backend; here every entry point takes an explicit `device`.
When it is None the device is `cuda`, and a machine without a GPU raises
instead of falling back to the CPU in silence. `is_hopper()` is cached:
the kernels are built for sm_90a and refuse other cards.

The JAX package runs one process over every device; the port runs one
process per rank of a `torch.distributed` group (`parallel/mesh.py`).
`device_count()` counts the CUDA devices this process sees, and `rank()`
and `world_size()` read the default group (0 and 1 without one).

This is the one module of the port that asks torch about the card
(`torch.cuda.is_available`, `device_count`, `get_device_name`,
`get_device_capability`): every other module calls the functions here
(`analysis/repo_lint.py`, rule platform-sniff).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The torch device an entry point runs on. None means `cuda`; a CUDA
    device on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def is_hopper() -> bool:
    """True when GPU 0 is a Hopper card (compute capability 9.0)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


def device_kind(device: torch.device) -> str:
    """The card's name for CUDA devices, "cpu" otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def cuda_available() -> bool:
    """Whether this process sees a CUDA device. Asked on every call (not
    cached), so a test may stand in for the answer."""
    return torch.cuda.is_available()


def device_count() -> int:
    """The CUDA devices this process sees (0 on a machine without one)."""
    return torch.cuda.device_count() if cuda_available() else 0


def device_capability(device: torch.device) -> Optional[Tuple[int, int]]:
    """The compute capability (major, minor) of a CUDA device, None for
    the CPU."""
    if device.type == "cuda":
        return tuple(torch.cuda.get_device_capability(device))
    return None


def rank(group=None) -> int:
    """This process's rank in `group` (the default group when None); 0
    when no process group is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def world_size(group=None) -> int:
    """The number of ranks of `group` (the default group when None); 1
    when no process group is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)
