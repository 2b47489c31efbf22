"""Plain PyTorch versions of the Mamba-2 SSD scan.

``ssd_chunked_ref`` computes what ``repro.models.ssd.ssd_chunked`` computes
(the chunked form every SSM and hybrid layer runs), with the same rounding
points: the intra-chunk matrix ``m`` is rounded to x's dtype before
``m @ x``, whose result is in x's dtype; the state weights
``rdecay * dt`` are rounded to x's dtype; ``y`` is rounded to x's dtype
last. Everything else is float32. The wrapper in ``ops`` takes this path
for CPU tensors; on the card it is what the CUDA kernel is held against.

``ssd_chunked_tiled_ref`` walks the scan as the bf16 kernels do (a chunk
kernel and an out kernel over 64-row tiles, the products split into bf16
pieces for the tensor cores); the card holds the kernels to it at a tight
tolerance.

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
import torch.nn.functional as F

TILE = 64          # rows of a query or key tile of the bf16 kernels
SCAN_WIDTH = 32    # positions per step of the kernels' warp scan of dt * A


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


def scan_cum(dA: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last dim, in the kernels' order: 32
    positions at a time by a Hillis-Steele scan (offsets 1, 2, 4, 8, 16),
    then the running total of the steps before added."""
    L = dA.shape[-1]
    nb = -(-L // SCAN_WIDTH)
    v = F.pad(dA, (0, nb * SCAN_WIDTH - L)).unflatten(-1, (nb, SCAN_WIDTH))
    for o in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], dim=-1)
    steps, carry = [], torch.zeros_like(v[..., 0, :1])
    for i in range(nb):
        step = v[..., i, :] + carry
        steps.append(step)
        carry = step[..., -1:]
    return torch.cat(steps, dim=-1)[..., :L]


def split_pieces(v: torch.Tensor, dtype: torch.dtype, k: int) -> list:
    """``v`` (float32) as ``k`` float32 tensors of values of ``dtype``,
    each the rounding of what the pieces before it left. Their sum is v
    exactly where v has at most 8 k significant bits and dtype is bfloat16:
    two pieces for a product of two bf16 values (16 bits), three for any
    float32 (24). For float32 the first piece is v and the rest are 0."""
    pieces, rest = [], v
    for _ in range(k):
        piece = rest.to(dtype).float()
        pieces.append(piece)
        rest = rest - piece
    return pieces


def ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` (bfloat16: 8 significant bits) at each
    value of v; 0 for float32, where the walk rounds nothing."""
    if dtype == torch.float32:
        return torch.zeros_like(v)
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 8)


def ssd_chunked_tiled_ref(x, dt, A, B, C, chunk: int,
                          initial_state: Optional[torch.Tensor] = None,
                          diag: bool = False):
    """The scan as K5's bf16 kernels walk it, in float32: the function of
    ``ssd_chunked_ref`` with its rounding points (to x's dtype), summed in
    the kernels' order where that order decides a rounding.

    1. Chunk kernel. Per (row, head), walking the chunks in order: cum by
       ``scan_cum``, the weights w = round(exp(cum_L - cum) dt), h_prev of
       the chunk (the state so far) split into three bf16 pieces (hi, mid,
       lo: exact), then h = h exp(cum_L) + B^T (w x) with w x split into
       two bf16 pieces (exact), so the tensor cores multiply exact values.
       Per (row, group, chunk): C.B^T in 64 x 64 tiles at or below the
       diagonal, once for all the group's heads.
    2. Out kernel, per (row, chunk, 64-row query tile, head): M[l, m] =
       round((C.B^T)[l, m] exp(cum_l - cum_m) dt_m) for l >= m (0 above
       the diagonal, selected before any product), y_diag = round(M @ x),
       y_off = C @ h_prev over its three pieces, y = y_diag +
       exp(cum_l) y_off.

    Returns (y (b, s, h, p) float32, before its last rounding to x's
    dtype; final state (b, g, h/g, n, p) float32), and with ``diag`` also
    the rounded y_diag (b, s, h, p): a kernel whose f32 sums differ may
    round y_diag the other way, one ``ulp`` of it. For float32 inputs every
    rounding and split is the identity."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    L = chunk_len(s, chunk)
    nc = s // L
    cdt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(cdt).float()

    xc = x.float().reshape(b, nc, L, g, hg, p)
    dtc = dt.float().reshape(b, nc, L, g, hg)
    Bc = B.float().reshape(b, nc, L, g, n)
    Cc = C.float().reshape(b, nc, L, g, n)

    # 1. chunk kernel
    dA = (dtc * A.float().reshape(g, hg)).movedim(2, -1)   # (b,nc,g,hg,L)
    cum = scan_cum(dA).movedim(-1, 2)                       # (b,nc,L,g,hg)
    w = rnd(torch.exp(cum[:, :, -1:] - cum) * dtc)
    wx = w[..., None] * xc
    S = sum(torch.einsum("bclgn,bclgkp->bcgknp", Bc, piece)
            for piece in split_pieces(wx, cdt, 2))
    nt = -(-L // TILE)
    cb = torch.zeros((b, nc, g, L, L), dtype=f32, device=x.device)
    for qt in range(nt):
        q0, q1 = qt * TILE, min(L, qt * TILE + TILE)
        for kt in range(qt + 1):
            k0, k1 = kt * TILE, min(L, kt * TILE + TILE)
            cb[:, :, :, q0:q1, k0:k1] = torch.einsum(
                "bclgn,bcmgn->bcglm", Cc[:, :, q0:q1], Bc[:, :, k0:k1])

    # the state walk over the chunks
    hcur = (initial_state.to(f32) if initial_state is not None
            else torch.zeros((b, g, hg, n, p), dtype=f32, device=x.device))
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * torch.exp(cum[:, c, -1])[..., None, None] + S[:, c]
    hprev = torch.stack(hprevs, dim=1)                      # (b,nc,g,hg,n,p)
    pieces = split_pieces(hprev, cdt, 3)

    # 2. out kernel, per query tile
    y = torch.empty((b, nc, L, g, hg, p), dtype=f32, device=x.device)
    y_diags = torch.empty_like(y)
    for qt in range(nt):
        q0, q1 = qt * TILE, min(L, qt * TILE + TILE)
        causal = (torch.arange(q0, q1, device=x.device)[:, None]
                  >= torch.arange(q1, device=x.device)[None, :])
        seg = cum[:, :, q0:q1, None] - cum[:, :, None, :q1]  # (b,nc,l,m,g,hg)
        m = cb[:, :, :, q0:q1, :q1].permute(0, 1, 3, 4, 2)[..., None] \
            * torch.exp(seg) * dtc[:, :, None, :q1]
        m = rnd(torch.where(causal[:, :, None, None], m, torch.zeros_like(m)))
        y_diag = rnd(torch.einsum("bclmgk,bcmgkp->bclgkp", m,
                                  xc[:, :, :q1]))
        y_off = sum(torch.einsum("bclgn,bcgknp->bclgkp", Cc[:, :, q0:q1],
                                 piece) for piece in pieces)
        y[:, :, q0:q1] = y_diag + y_off * torch.exp(cum[:, :, q0:q1])[..., None]
        y_diags[:, :, q0:q1] = y_diag
    if diag:
        return y.reshape(b, s, h, p), hcur, y_diags.reshape(b, s, h, p)
    return y.reshape(b, s, h, p), hcur
