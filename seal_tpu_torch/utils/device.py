"""Where the port's constructors put their tensors, and what they take.

The entry points run on the card unless the caller asks for the CPU: the
default ``device`` of every constructor is ``"cuda"``, and asking for CUDA
where no CUDA device exists raises instead of falling back to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_DEVICE = "cuda"


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev


def resolve_device(name) -> torch.device:
    """A ``--device`` flag's value: ``auto``, ``cuda`` and ``cuda:N`` name the
    card (``auto`` never falls back to the CPU), ``cpu`` the CPU; raises
    ``RuntimeError`` for CUDA without a card and ``ValueError`` for any
    other device."""
    try:
        dev = torch.device("cuda" if name in (None, "", "auto") else name)
    except RuntimeError as e:  # a device type torch does not know
        raise ValueError(f"device {name!r}: the port runs on cuda or cpu") from e
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the port runs on cuda or cpu")
    return checked_device(dev)


def tensor_bytes(obj) -> int:
    """Device bytes of every tensor field of the dataclass ``obj``."""
    arrays = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return sum(a.numel() * a.element_size() for a in arrays if isinstance(a, torch.Tensor))
