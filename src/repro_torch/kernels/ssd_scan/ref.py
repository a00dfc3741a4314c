"""Plain PyTorch version of the SSD chunked-scan kernel.

Follows the JAX package's ``models/mamba2.py::ssd_chunked`` step by step:
within a chunk of ``chunk`` tokens the quadratic form (the masked decay
matrix, the C.B^T Gram, the intra-chunk product), across chunks a
first-order recurrence of the (H, P, N) state, entered from ``h0``.  All
math is fp32, or fp64 for float64 inputs (an oracle with the same
arithmetic); ``y`` comes back in x's dtype, the final state in the math's
dtype.
Padding is dt = 0 (decay 1, no input), so a ragged last chunk leaves the
state as the real tokens left it.  The wrapper in ``kernel.py`` runs it for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it on
the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor] = None,
                   *, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P); dt (B, L, H) (>= 0); A (H,) (< 0); Bm, Cm (B, L, N),
    shared by every head; h0 (B, H, P, N) or None (zero) ->
    ``(y (B, L, H, P) in x's dtype, h_final (B, H, P, N) fp32)`` (fp64 for
    float64 x)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    ft = torch.promote_types(x.dtype, torch.float32)
    state = (torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device) if h0 is None
             else h0.to(ft))
    if L == 0:
        return x.new_empty((Bsz, 0, H, P)), state.clone()
    Q = min(chunk, L)
    pad = (-L) % Q
    xf, dtf, Bf, Cf = x.to(ft), dt.to(ft), Bm.to(ft), Cm.to(ft)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))           # dt = 0: decay 1, input 0
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (L + pad) // Q
    xc = xf.reshape(Bsz, nc, Q, H, P)
    dtc = dtf.reshape(Bsz, nc, Q, H)
    Bc = Bf.reshape(Bsz, nc, Q, N)
    Cc = Cf.reshape(Bsz, nc, Q, N)

    cums = torch.cumsum(dtc * A.to(ft), dim=2)                 # (B, nc, Q, H)

    # intra-chunk: L[i, j] = exp(cums_i - cums_j) for i >= j, the mask
    # inside the exp (a positive difference is never exponentiated)
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]       # (B, nc, Q, Q, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                 torch.tensor(float("-inf"), device=x.device)))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                # (B, nc, Q, Q)
    w = cb[..., None] * Lmat * dtc[:, :, None, :, :]            # (B, nc, Q, Q, H)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # each chunk's own state contribution, then the recurrence across chunks
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)         # (B, nc, Q, H)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_to_end * dtc, Bc, xc)
    chunk_decay = torch.exp(cums[:, :, -1, :])                  # (B, nc, H)
    h_prev = []
    for c in range(nc):
        h_prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                         # (B, nc, H, P, N)

    # inter-chunk: the state entering each chunk, read through C
    y = y + torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cums), h_prev)
    y = y.reshape(Bsz, nc * Q, H, P)[:, :L]
    return y.to(x.dtype), state
