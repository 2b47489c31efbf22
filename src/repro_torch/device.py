"""Device and dtype resolution shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
only a caller that asks for the CPU (``device="cpu"``, as the tests do)
runs there, so a missing card is never silently replaced by the host.
``meta`` (shapes and dtypes, no storage) is what the dry-run sizes on: it
allocates nothing and stands in for no card."""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}
FP8 = torch.float8_e4m3fn
# the largest |x| the reference's cast rounds to a finite e4m3 value: 448
# is the largest, and 464 is the midpoint to the next step (480), which
# ties to even, onto 448; beyond it ml_dtypes gives NaN
FP8_ROUNDS_FINITE = 464.0


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
    """A config's dtype name ("float32", "bfloat16", "float8_e4m3fn") as a
    torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` as the reference's ``astype`` casts it: plain
    ``.to`` for every type but float8_e4m3fn, where ml_dtypes (the
    reference's cast) maps |x| > 464, +-inf and NaN to NaN and torch's
    ``.to`` saturates them to +-448. Values up to 464 round to nearest even
    in both (464 itself to 448). So those are made NaN first, which
    torch's cast keeps."""
    if dtype != FP8:
        return x.to(dtype)
    keep = x.isfinite() & (x.abs() <= FP8_ROUNDS_FINITE)
    return torch.where(keep, x, float("nan")).to(dtype)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its uint8 bits (a view), any other tensor itself:
    the form that moves bytes through indexing, ``index_copy_`` and
    ``torch.where``, which torch does not implement for every float8
    type on every device."""
    return t.view(torch.uint8) if t.dtype == FP8 else t
