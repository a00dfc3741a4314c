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


# -- the backward --------------------------------------------------------------------------------


def _hilo(v: torch.Tensor) -> torch.Tensor:
    """v as the kernel's bf16 hi + lo pair sees it: hi = bf16(v), lo =
    bf16(v - hi), summed back in v's dtype (within 2^-16 |v| of v)."""
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi + (v - hi).to(torch.bfloat16).to(v.dtype)


def _backward(x, dt, A, Bm, Cm, h0, dy, dh_final, chunk: int, *, mag: bool = False,
              drop: Optional[int] = None, split: bool = False):
    """The chunked adjoint (see :func:`ssd_scan_backward_plain`), in the
    math dtype, before any cast.  ``mag``: every subtraction of the adjoint
    of the exponents becomes an addition and A enters the step's gradient
    as |A|, so that on |x|, |B|, |C|, |h0|, |dy| and |dh_final| each
    output is the sum of its terms' magnitudes.  ``drop``: chunk ``drop``'s
    contribution to the state's adjoint is left out.  ``split``: every fp32
    operand the tensor-core route splits enters as its bf16 hi + lo pair
    (:func:`_hilo`): x wend dt and dy exp(cums) in the state passes, the
    states and adjoints the chunk kernel reads, W, and the sum of dG over
    heads."""
    sp = _hilo if split else (lambda v: v)
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    ft = torch.promote_types(x.dtype, torch.float32)
    dev = x.device
    Q = min(chunk, L)
    pad = (-L) % Q
    xf, dtf, Bf, Cf, dyf = x.to(ft), dt.to(ft), Bm.to(ft), Cm.to(ft), dy.to(ft)
    if pad:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))           # dt = 0: decay 1, input 0
        Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    nc = (L + pad) // Q
    xc, dyc = xf.reshape(Bsz, nc, Q, H, P), dyf.reshape(Bsz, nc, Q, H, P)
    dtc = dtf.reshape(Bsz, nc, Q, H)
    Bc, Cc = Bf.reshape(Bsz, nc, Q, N), Cf.reshape(Bsz, nc, Q, N)
    Af = A.to(ft)

    cums = torch.cumsum(dtc * Af, dim=2)                        # (B, nc, Q, H)
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]       # (B, nc, i, j, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                 torch.tensor(float("-inf"), device=dev, dtype=ft)))
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    W = G[..., None] * Lmat * dtc[:, :, None, :, :]             # W_ij, (B, nc, i, j, H)
    last = cums[:, :, -1, :]                                    # (B, nc, H)
    wend_ = torch.exp(last[:, :, None, :] - cums)               # exp(cums_last - cums_j)
    ecum = torch.exp(cums)
    decay = torch.exp(last)

    # the state entering each chunk, then the state's adjoint leaving each
    # chunk (walked from the end)
    states = torch.einsum("bcqhp,bcqn->bchpn", sp((wend_ * dtc)[..., None] * xc), Bc)
    h = (torch.zeros((Bsz, H, P, N), dtype=ft, device=dev) if h0 is None else h0.to(ft))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                         # (B, nc, H, P, N)
    dstates = torch.einsum("bcqhp,bcqn->bchpn", sp(ecum[..., None] * dyc), Cc)
    if drop is not None:
        dstates[:, drop] = 0.0
    dh = (torch.zeros((Bsz, H, P, N), dtype=ft, device=dev) if dh_final is None
          else dh_final.to(ft))
    dh_out = [None] * nc
    for c in reversed(range(nc)):
        dh_out[c] = dh
        dh = dh * decay[:, c, :, None, None] + dstates[:, c]
    dh_out = torch.stack(dh_out, dim=1)                         # (B, nc, H, P, N)
    h_prev, dh_out = sp(h_prev), sp(dh_out)

    # within each chunk
    dW = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    E = dW * G[..., None] * Lmat                                # dW_ij G_ij exp(cums_i - cums_j)
    dG = dW * Lmat * dtc[:, :, None, :, :]
    R = E * dtc[:, :, None, :, :]                               # the exponents' adjoint, per pair
    dx = (torch.einsum("bcijh,bcihp->bcjhp", sp(W), dyc)
          + (wend_ * dtc)[..., None] * torch.einsum("bcjn,bchpn->bcjhp", Bc, dh_out))
    dCi = ecum[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc, h_prev)
    dGs = sp(dG.sum(-1))                                        # dG summed over heads
    dC = torch.einsum("bcij,bcjn->bcin", dGs, Bc) + dCi.sum(3)
    dBi = wend_[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", xc, dh_out)
    dB = torch.einsum("bcij,bcin->bcjn", dGs, Cc) + (dBi * dtc[..., None]).sum(3)
    S = torch.einsum("bcin,bcihn->bcih", Cc, dCi)               # dy_i . (the state's y_i)
    T = torch.einsum("bcjn,bcjhn->bcjh", Bc, dBi)               # dh . (x_j B_j^T) exp(..)
    U = decay * torch.einsum("bchpn,bchpn->bch", dh_out, h_prev)
    s = 1.0 if mag else -1.0
    dcums = R.sum(3) + s * R.sum(2) + S + s * dtc * T
    dcums[:, :, -1] += (dtc * T).sum(2) + U
    da = dcums.flip(2).cumsum(2).flip(2)                        # d(dt * A), per token
    ddt = E.sum(2) + T + (Af.abs() if mag else Af) * da
    dA = (dtc * da).sum((0, 1, 2))
    return (dx.reshape(Bsz, nc * Q, H, P)[:, :L], ddt.reshape(Bsz, nc * Q, H)[:, :L], dA,
            dB.reshape(Bsz, nc * Q, N)[:, :L], dC.reshape(Bsz, nc * Q, N)[:, :L], dh)


BACKWARD_NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dh0")


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor],
                            dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None, *,
                            chunk: int = 256):
    """The adjoint of :func:`ssd_scan_plain`: given ``dy`` (B, L, H, P) and
    ``dh_final`` (B, H, P, N) or None (no gradient on the final state) ->
    ``(dx, ddt, dA, dBm, dCm, dh0)``, each in its input's dtype (dh0 None
    when h0 is None); fp32 math (fp64 for float64 x).

    Per chunk, with ``cums`` the inclusive cumsum of dt A, G = C B^T, W_ij
    = G_ij exp(cums_i - cums_j) dt_j (j <= i), ``h_prev`` the state
    entering the chunk and ``dh`` the adjoint of the state leaving it,
    walked backwards over chunks (``dh_prev = exp(cums_last) dh + sum_i
    exp(cums_i) dy_i C_i^T``; after the first chunk it is dh0):

        dx_j  = sum_i W_ij dy_i + exp(cums_last - cums_j) dt_j (dh B_j)
        dW_ij = dy_i . x_j;  dG_ij = dW_ij exp(cums_i - cums_j) dt_j
        dC_i  = sum_h [sum_j dG_ij B_j + exp(cums_i) h_prev^T dy_i]
        dB_j  = sum_h [sum_i dG_ij C_i + exp(cums_last - cums_j) dt_j dh^T x_j]
        ddt_j = sum_i dW_ij G_ij exp(cums_i - cums_j)
                + exp(cums_last - cums_j) x_j . (dh B_j) + A da_j
        dA    = sum over b and l of da dt

    where ``da`` is the reversed cumsum over the chunk of d(cums), which
    collects the terms of exp(cums_i - cums_j) (+ on i, - on j), exp(cums_i)
    (dy_i . the state's share of y_i), exp(cums_last - cums_j) (- on j, +
    on the last token) and exp(cums_last) (dh . h_prev, on the last token).
    Masked pairs (j > i) take an exponent of -inf, so no positive
    difference is ever exponentiated."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if L == 0:
        dh0 = None
        if h0 is not None:
            dh0 = (torch.zeros_like(h0) if dh_final is None else dh_final.to(h0.dtype).clone())
        return (torch.zeros_like(x), torch.zeros_like(dt), torch.zeros_like(A),
                torch.zeros_like(Bm), torch.zeros_like(Cm), dh0)
    dx, ddt, dA, dB, dC, dh0 = _backward(x, dt, A, Bm, Cm, h0, dy, dh_final, chunk)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), None if h0 is None else dh0.to(h0.dtype))


def _cast(tensors, dtype):
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def _chunk_sums(dt, A, seg: int) -> torch.Tensor:
    """M (B, H): the largest sum of |dt A| over one chunk of ``seg`` tokens."""
    Bsz, L, H = dt.shape
    Q = max(min(seg, L), 1)
    dA = F.pad((dt.double() * A.double()).abs(), (0, 0, 0, (-L) % Q)).reshape(Bsz, -1, Q, H)
    return dA.sum(2).amax(1)


def ssd_scan_backward_split_emulation(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                                      Bm: torch.Tensor, Cm: torch.Tensor,
                                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                                      dh_final: Optional[torch.Tensor] = None, *,
                                      kernel_chunk: int = KERNEL_CHUNK):
    """The tensor-core backward's split arithmetic on the CPU, in fp32: the
    plain backward on chunks of ``kernel_chunk`` tokens with every operand
    the kernel splits rounded to its bf16 hi + lo pair (x wend dt and dy
    exp(cums) in the state passes, h_prev and dh where the chunk kernel
    reads them, W, and the sum of dG over heads) -> ``(dx, ddt, dA, dBm,
    dCm, dh0)`` in fp32, before the store's rounding.  What the kernel's
    products leave out of this model is fp32 summation order."""
    args = _cast((x, dt, A, Bm, Cm, h0, dy, dh_final), torch.float32)
    out = _backward(*args, kernel_chunk, split=True)
    return out[:5] + ((None,) if h0 is None else out[5:])


def bf16_backward_rounding_bound(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                                 Bm: torch.Tensor, Cm: torch.Tensor,
                                 h0: Optional[torch.Tensor], dy: torch.Tensor,
                                 dh_final: Optional[torch.Tensor] = None, *, chunk: int = 256,
                                 kernel_chunk: int = KERNEL_CHUNK,
                                 kernel_route: str = "cuda_core"):
    """``(want, bound)``, each a tuple ordered as :data:`BACKWARD_NAMES`
    (dh0 None without h0), fp32: the plain backward in fp32 on the same
    inputs (bf16 values where the inputs are bf16), and the per-element
    limit of the kernel's gradients against it, on the route
    ``kernel_route`` with its chunk ``kernel_chunk``.

    The CUDA-core route computes in fp32 from the inputs' exact values, so
    it departs from the fp32 plain version by summation order and by its
    exponents alone; the tensor-core route also by its splits (below).
    Both round dx, dBm and dCm to the inputs' dtype at the store (ddt, dA
    and dh0 stay fp32).  Every term of every gradient is a product of the
    inputs, the decays and dt; the same adjoint run on |x|, |B|, |C|,
    |h0|, |dy| and |dh_final| in float64 with its subtractions made
    additions (``mag``) gives each output's sum of term magnitudes
    ``g_abs``.  Relative to it:

    * fp32 sums, both sides, each at most ``m`` deep: ``e_sum = 2^-24 m``,
      ``m = 2 (Qc + N + P + 16) + nc`` for dx, ddt and dh0 (``Qc`` the longer
      of this version's and the kernel's chunk, ``nc`` the kernel's chunks,
      whose states carry roundings), ``+ H`` for dBm and dCm (a sum over
      heads) and ``+ B L`` for dA;
    * the exponents: each side's fp32 cumsum of dt A misses by ``d |cums|``,
      ``d = SCAN_DEPTH 2^-24`` (as :func:`bf16_rounding_bound` takes it), so a
      term's factor exp(cums_i - cums_j), exp(cums_i) or exp(cums_last - ..)
      is off by at most ``4 d M`` between the two sides and a carried
      state's by ``4 d M`` more (M (B, H): the largest sum of |dt A| over
      one chunk of ``Qc`` tokens).  Every term is linear in head h's (dy,
      dh_final), so the magnitude run on |dy| and |dh_final| scaled by ``8 d
      M[b, h]`` gives each output's share of this error, heads summed;
    * underflow: where the decays reach below fp32's normal range, each of
      the ``m`` steps of a sum may lose up to the smallest normal, 2^-126;
    * on the tensor-core route, its splits: an fp32 operand entering a
      product as a bf16 hi + lo pair is off by at most ``u^2 = 2^-16`` of
      its size.  A term's path holds at most four (x wend dt or dy exp(cums)
      in a pass, then the state or adjoint where the chunk kernel reads it,
      for each of h_prev and dh in dh . h_prev; W or the sum of dG over heads
      is one), and, counted as the forward's bound counts them, one more at
      each chunk boundary a carried state or adjoint crosses (at most
      ``nc - 1``): ``e_split = (nc + 3) u^2``, ``nc`` the kernel's chunks.
      The CUDA-core route splits nothing: ``e_split = 0``.

    Then the store, at unit roundoff ``u_s`` (2^-8 for bf16 outputs, 2^-24
    for fp32):

        bound = u_s |want| + (1 + u_s) ((e_sum + e_split) g_abs + g_exp + 2^-126 m)
    """
    if kernel_route not in ("cuda_core", "tensor_core"):
        raise ValueError(f"kernel_route is cuda_core or tensor_core, got {kernel_route!r}")
    f32, f64 = torch.float32, torch.float64
    want = ssd_scan_backward_plain(*_cast((x, dt, A, Bm, Cm, h0, dy, dh_final), f32),
                                   chunk=chunk)
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if L == 0:
        return want, tuple(None if w is None else torch.zeros_like(w) for w in want)
    Qc = max(chunk, kernel_chunk)
    M = _chunk_sums(dt, A, Qc)                                  # (B, H)
    kappa = 8 * SCAN_DEPTH * FP32_U * M
    args = (x.to(f64).abs(), dt.to(f64), A.to(f64), Bm.to(f64).abs(), Cm.to(f64).abs(),
            None if h0 is None else h0.to(f64).abs())
    dya, dfa = dy.to(f64).abs(), None if dh_final is None else dh_final.to(f64).abs()
    g_abs = _backward(*args, dya, dfa, chunk, mag=True)
    g_exp = _backward(*args, dya * kappa[:, None, :, None],
                      None if dfa is None else dfa * kappa[:, :, None, None], chunk, mag=True)
    nc = math.ceil(L / min(kernel_chunk, L))
    e_split = (nc + 3) * BF16_U ** 2 if kernel_route == "tensor_core" else 0.0
    base = 2 * (Qc + N + P + 16) + nc
    depth = {"dx": base, "ddt": base, "dA": base + Bsz * L, "dBm": base + H, "dCm": base + H,
             "dh0": base}
    low = {"dx": x.dtype, "dBm": Bm.dtype, "dCm": Cm.dtype}
    bounds = []
    for name, w, ga, ge in zip(BACKWARD_NAMES, want, g_abs, g_exp, strict=True):
        if w is None:
            bounds.append(None)
            continue
        us = BF16_U if low.get(name) == torch.bfloat16 else FP32_U
        err = FP32_U * depth[name] * ga + ge + 2.0 ** -126 * depth[name]
        if e_split:
            err = err + e_split * ga
        bounds.append((us * w.to(f64).abs() + (1 + us) * err).to(f32))
    return want, tuple(bounds)


def dropped_chunk_effects(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor],
                          dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None, *,
                          chunk: int = 256, drop: Optional[int] = None) -> dict:
    """What a backward that lost one chunk's contribution to the state's
    adjoint (``sum_i exp(cums_i) dy_i C_i^T`` of chunk ``drop``, the last
    chunk by default) would get wrong: ``{name: |change|}``, per element,
    for each gradient of :data:`BACKWARD_NAMES` that it changes (fp32 plain
    backward; chunks of ``chunk`` tokens).  The dropped share reaches every
    earlier chunk's dx, ddt and dBm, dA, and dh0 through the state's
    adjoint; dCm does not depend on it.  A kernel that lost it would break
    a per-element limit wherever the change exceeds the limit."""
    args = _cast((x, dt, A, Bm, Cm, h0, dy, dh_final), torch.float32)
    L = x.shape[1]
    drop = math.ceil(L / min(chunk, max(L, 1))) - 1 if drop is None else drop
    full = _backward(*args, chunk)
    lost = _backward(*args, chunk, drop=drop)
    out = {}
    for name, g, gl in zip(BACKWARD_NAMES, full, lost, strict=True):
        if name == "dh0" and h0 is None:
            continue
        diff = (g - gl).abs()
        if diff.numel() and diff.max().item() > 0:
            out[name] = diff
    return out
