"""Plain PyTorch versions of the Mamba-2 SSD scan.

``ssd_chunked_ref`` computes what ``repro.models.ssd.ssd_chunked`` computes
(the chunked form every SSM and hybrid layer runs), with the same rounding
points: the intra-chunk matrix ``m`` is rounded to x's dtype before
``m @ x``, whose result is in x's dtype; the state weights
``rdecay * dt`` are rounded to x's dtype; ``y`` is rounded to x's dtype
last. Everything else is float32. The wrapper in ``ops`` takes this path
for CPU tensors; on the card it is what the CUDA kernel is held against.

``ssd_sequential_ref`` is the sequential recurrence of
``repro.kernels.ssd.ref.ssd_ref``, the oracle both the chunked form and the
kernel must match.

Shapes: x (b, s, h, p); dt (b, s, h) float32 after softplus; A (h,)
negative; B, C (b, s, g, n) with h % g == 0; states (b, g, h/g, n, p)
float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length ``min(chunk, s)``; raises ``ValueError`` unless it
    divides s, as the reference does."""
    L = min(chunk, s)
    if L < 1 or s % L:
        raise ValueError(f"seq {s} not divisible by chunk {L}")
    return L


def ssd_chunked_ref(x, dt, A, B, C, chunk: int,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, s, h, p) in x's dtype, final state (b, g, h/g, n, p)
    float32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    L = chunk_len(s, chunk)
    nc = s // L
    f32 = torch.float32

    xc = x.reshape(b, nc, L, g, hg, p)
    dtc = dt.reshape(b, nc, L, g, hg).to(f32)
    Bc = B.reshape(b, nc, L, g, n).to(f32)
    Cc = C.reshape(b, nc, L, g, n).to(f32)

    dA = dtc * A.reshape(g, hg).to(f32)                     # <= 0
    cum = torch.cumsum(dA, dim=2)                           # inclusive

    # intra-chunk (dense, causal)
    cb = torch.einsum("bclgn,bcmgn->bclmg", Cc, Bc)
    seg = cum[:, :, :, None] - cum[:, :, None, :]           # (b,nc,L,L,g,hg)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[:, :, None, None], seg,
                                  torch.full_like(seg, -1e30)))
    m = cb[..., None] * decay * dtc[:, :, None]             # M[l, m]
    y_diag = torch.einsum("bclmgk,bcmgkp->bclgkp", m.to(x.dtype), xc)

    # chunk states
    rdecay = torch.exp(cum[:, :, -1:] - cum)                # (b,nc,L,g,hg)
    w = (rdecay * dtc).to(x.dtype).to(f32)
    S = torch.einsum("bclgn,bclgk,bclgkp->bcgknp", Bc, w, xc.to(f32))
    chunk_decay = torch.exp(cum[:, :, -1])                  # (b,nc,g,hg)

    hcur = (initial_state.to(f32) if initial_state is not None
            else torch.zeros((b, g, hg, n, p), dtype=f32, device=x.device))
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, ..., None, None] + S[:, c]
    hprev = torch.stack(hprevs, dim=1)                      # (b,nc,g,hg,n,p)

    # inter-chunk contribution
    y_off = torch.einsum("bclgn,bcgknp->bclgkp", Cc, hprev) \
        * torch.exp(cum)[..., None]
    y = (y_diag.to(f32) + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), hcur


def ssd_sequential_ref(x, dt, A, B, C,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step-by-step recurrence in float32. Returns (y (b, s, h, p) in
    x's dtype, final state (b, g, h/g, n, p))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    f32 = torch.float32
    xf = x.to(f32).reshape(b, s, g, hg, p)
    dtf = dt.to(f32).reshape(b, s, g, hg)
    Bf, Cf = B.to(f32), C.to(f32)
    dec = torch.exp(dtf * A.to(f32).reshape(g, hg))
    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((b, g, hg, n, p), dtype=f32, device=x.device))
    ys = []
    for t in range(s):
        upd = torch.einsum("bgn,bgk,bgkp->bgknp", Bf[:, t], dtf[:, t],
                           xf[:, t])
        state = state * dec[:, t, ..., None, None] + upd
        ys.append(torch.einsum("bgn,bgknp->bgkp", Cf[:, t], state))
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), state
