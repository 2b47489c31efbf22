"""The gradient of the Mamba-2 SSD chunked scan (K5), for ``ops.SSDFn``.

The TPU kernel has no backward: the reference trains through XLA's
autodiff of ``repro.models.ssd.ssd_chunked``. ``ssd_backward`` is that
autodiff here: it recomputes the plain chunked scan
(``ref.ssd_chunked_ref``, the same function with the same rounding points)
from the saved inputs under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` of its outputs. The recompute's values are
discarded: the forward value is always the kernel's. Each call adds one
to ``ssd_backward.calls``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssd.ref import ssd_chunked_ref


def ssd_backward(x, dt, A, B, C, chunk: int,
                 initial_state: Optional[torch.Tensor], dy, dstate):
    """Inputs as ``ops.ssd``; dy (b, s, h, p) and dstate (b, g, h/g, n, p)
    the gradients of its two outputs (either may be None: zero). Returns
    (dx, ddt, dA, dB, dC, dinitial_state), each in its input's dtype and
    shape; dinitial_state is None without an initial state."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() if t is not None else None
               for t in (x, dt, A, B, C, initial_state)]
        y, state = ssd_chunked_ref(*ins[:5], chunk, ins[5])
        outs = [(o, g) for o, g in ((y, dy), (state, dstate))
                if g is not None]
        live = [t for t in ins if t is not None]
        grads = torch.autograd.grad([o for o, _ in outs],
                                    live, [g for _, g in outs],
                                    allow_unused=True)
    it = iter(grads)
    out = [next(it) if t is not None else None for t in ins]
    out = [torch.zeros_like(t) if g is None and t is not None else g
           for t, g in zip(ins, out)]
    ssd_backward.calls += 1
    return tuple(out)


ssd_backward.calls = 0
