"""Device and dtype resolution shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
only a caller that asks for the CPU (``device="cpu"``, as the tests do)
runs there, so a missing card is never silently replaced by the host.
``meta`` (shapes and dtypes, no storage) is what the dry-run sizes on: it
allocates nothing and stands in for no card."""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def seeded_generator(dev: torch.device, seed: int):
    """A generator on ``dev`` seeded with ``seed``; None on ``meta``, which
    has no generator and draws nothing."""
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def runs_kernels(dev: torch.device) -> bool:
    """Whether the model sends work on ``dev`` to the kernels: on the card,
    and on ``meta``, so that the dry-run sizes the path the card runs."""
    return dev.type in ("cuda", "meta")


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16", ...) as a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None
