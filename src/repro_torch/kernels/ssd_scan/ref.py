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
the card.  :func:`bf16_rounding_bound` is the per-element limit the
kernel's bf16 result is held to against this version in fp32, and
:func:`fp32_rounding_bound` the one its fp32 result is held to against this
version in float64 where the cumsums of dt * A grow large.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BF16_U = 2.0 ** -8          # bf16's unit roundoff: half an ulp, relative
FP32_U = 2.0 ** -24
KERNEL_CHUNK = 64           # the tensor-core route's shortest chunk, the CUDA-core route's longest
SCAN_DEPTH = 40             # roundings allowed in one cumsum of dt * A, both sides


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


def _magnitudes(x, dt, A, Bm, Cm, h0, chunk: int, seg: int):
    """``(y_abs, h_abs, w, M)`` in float64: the recurrence run on |x|, |B|,
    |C| and |h0| (every term of ``y`` and of the state by its magnitude),
    and the exponents' weights on chunks of ``seg`` tokens: ``w_i = |cums_i|``
    within a chunk (+ M past the first), M (B, H) the largest sum of |dt A|
    over one chunk of each row and head."""
    f64 = torch.float64
    y_abs, h_abs = ssd_scan_plain(x.to(f64).abs(), dt.to(f64), A.to(f64), Bm.to(f64).abs(),
                                  Cm.to(f64).abs(), None if h0 is None else h0.to(f64).abs(),
                                  chunk=chunk)
    Bsz, L, H, _ = x.shape
    Q = max(min(seg, L), 1)
    dA = F.pad((dt.to(f64) * A.to(f64)).abs(), (0, 0, 0, (-L) % Q)).reshape(Bsz, -1, Q, H)
    cums = dA.cumsum(dim=2)                                     # (B, nc, Q, H), |cums|
    M = cums[:, :, -1].amax(dim=1)                              # (B, H)
    w = cums.clone()
    w[:, 1:] += M[:, None, None, :]
    return y_abs, h_abs, w.reshape(Bsz, -1, H)[:, :L, :, None], M


def bf16_rounding_bound(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor] = None,
                        *, chunk: int = 256, kernel_chunk: Optional[int] = KERNEL_CHUNK):
    """``(want_y, bound_y, want_h, bound_h)``: the fp32 plain version's ``y``
    and final state on the (bf16-valued) inputs, and the per-element limits
    of the kernel's ``y`` (bf16) and state (fp32) against them.

    Every term of ``y`` and of the state is a product of the inputs, decays
    and dt; the same recurrence on |x|, |B|, |C| and |h0| in float64 gives
    ``y_abs`` and ``h_abs``, their sums of magnitudes.  What the kernel
    rounds, relative to those magnitudes:

    * on the tensor-core route's chunk kernel, the bf16 hi + lo splits of
      its three fp32 operands (the decayed C.B^T weights, h_prev and
      x * wend): ``u^2`` each (``u = 2^-8``), once more at each of the at
      most ``ceil(L / kernel_chunk) + 2`` chunk boundaries a term crosses
      in the state: ``e_split = (ceil(L / kernel_chunk) + 2) 3 u^2``.
      ``kernel_chunk=None`` is a kernel that splits nothing (the decode
      kernel at L = 1 and the CUDA-core route are fp32 throughout):
      ``e_split = 0``;
    * fp32 sums of at most ``2 max(chunk, 128) + 2 N`` products, on both
      sides: ``e_sum = 2^-24 (2 max(chunk, 128) + 2 N + 16)``;
    * the exponents: each side's fp32 cumsum of dt * A misses by
      ``d |cums|`` with ``d = SCAN_DEPTH 2^-24`` (the kernel's scan rounds
      about 10 times; the plain version sums up to 256 terms in order, whose
      roundings add like a random walk, about 16; the rest is exp's own
      rounding and margin).  Within one of this version's chunks (which
      hold the kernel's) |cums| only grows, so term (i, j) is off by at most
      ``2 d |cums_i|``; a term carried from an earlier chunk by up to ``2 d
      M`` more (M: the largest sum of |dt A| over one chunk of its row and
      head).

    Then ``y`` is rounded to bf16 once:

        bound_y = u |want_y| + (1 + u) ((e_split + e_sum + 2 d w) y_abs),
        w_i = |cums_i| (+ M past the first chunk),
        bound_h = (e_split + e_sum + 4 d M) h_abs.
    """
    f32 = torch.float32
    want_y, want_h = ssd_scan_plain(x.to(f32), dt.to(f32), A.to(f32), Bm.to(f32), Cm.to(f32),
                                    None if h0 is None else h0.to(f32), chunk=chunk)
    y_abs, h_abs, w, M = _magnitudes(x, dt, A, Bm, Cm, h0, chunk, chunk)
    L, N = x.shape[1], Bm.shape[-1]
    splits = 0 if kernel_chunk is None else math.ceil(L / kernel_chunk) + 2
    d = SCAN_DEPTH * FP32_U
    e = splits * 3 * BF16_U ** 2 + FP32_U * (2 * max(chunk, 128) + 2 * N + 16)
    bound_y = BF16_U * want_y.abs() + ((1 + BF16_U) * (e + 2 * d * w) * y_abs).to(f32)
    return want_y, bound_y, want_h, ((e + 4 * d * M[..., None, None]) * h_abs).to(f32)


def fp32_rounding_bound(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor] = None,
                        *, chunk: int = 256, kernel_chunk: int = KERNEL_CHUNK):
    """``(want_y, bound_y)``: this version's ``y`` in float64 (the oracle)
    on fp32 inputs, and the per-element limit of an fp32 kernel's ``y``
    against it: the CUDA-core route, fp32 throughout, on chunks of at most
    ``kernel_chunk`` tokens (a power of two, or all of L below it).

    Only the kernel rounds, as :func:`bf16_rounding_bound` counts it with
    no split: fp32 sums (``e_sum`` as there, the other side's share kept as
    margin) and the exponents.  Its cumsums of dt * A restart at each of its
    chunks, so ``w`` is taken on chunks of ``kernel_chunk``; and a token's
    own term (i = j) has the exponent 0 exactly, so the exponents' share
    applies to the rest of ``y_abs`` alone (``y_off``, ``y_abs`` less
    ``dt_i (|C_i| . |B_i|) |x_i|``).  Then ``y``'s fp32 rounding:

        bound_y = 2^-24 |want_y| + (1 + 2^-24) (e_sum y_abs + 2 d w y_off).

    At |A dt| ~ 100 the cumsums reach thousands within a chunk and the
    exponents' share is the larger; it grows with the chunk's length.
    """
    f64 = torch.float64
    want_y, _ = ssd_scan_plain(x.to(f64), dt.to(f64), A.to(f64), Bm.to(f64), Cm.to(f64),
                               None if h0 is None else h0.to(f64), chunk=chunk)
    y_abs, _, w, _ = _magnitudes(x, dt, A, Bm, Cm, h0, chunk, kernel_chunk)
    own = ((dt.to(f64) * (Cm.to(f64).abs() * Bm.to(f64).abs()).sum(-1)[..., None])[..., None]
           * x.to(f64).abs())
    y_off = (y_abs - own).clamp(min=0.0)
    d = SCAN_DEPTH * FP32_U
    e = FP32_U * (2 * max(chunk, 128) + 2 * Bm.shape[-1] + 16)
    return want_y, FP32_U * want_y.abs() + (1 + FP32_U) * (e * y_abs + 2 * d * w * y_off)


def dropped_token_effect(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor] = None,
                         *, chunk: int = 256) -> Tuple[int, float]:
    """``(t, effect)``: the token t whose input moves its own row of ``y``
    the most, and the largest change of the fp32 plain version's ``y`` at
    row t when x_t is left out: the size of the error a kernel that lost
    one token would make there.

    Leaving out x_t changes row t by its diagonal term alone,
    ``dt_t (C_t . B_t) x_t`` (the decay from a token to itself is 1), so
    t is picked by that term's largest magnitude over rows, heads and P;
    the effect is then measured by running the plain version without
    x_t."""
    f32 = torch.float32
    diag = (dt.to(f32) * (Cm.to(f32) * Bm.to(f32)).sum(-1)[..., None])[..., None] * x.to(f32)
    t = int(diag.abs().amax(dim=(0, 2, 3)).argmax())
    args = [x.to(f32), dt.to(f32), A.to(f32), Bm.to(f32), Cm.to(f32),
            None if h0 is None else h0.to(f32)]
    y, _ = ssd_scan_plain(*args, chunk=chunk)
    args[0] = args[0].clone()
    args[0][:, t] = 0.0
    y_drop, _ = ssd_scan_plain(*args, chunk=chunk)
    return t, (y[:, t] - y_drop[:, t]).abs().max().item()
