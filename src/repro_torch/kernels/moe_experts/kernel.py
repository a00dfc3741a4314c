"""Grouped expert FFN, routing and combine, forward and backward: the
hand-written CUDA kernels' wrappers.

``kernels/csrc/moe_experts.cu`` holds the three forward kernels.  :func:`moe_experts_kernel`
runs one launch of the grouped expert product over the routed (token,
expert) pairs sorted by expert, each expert's segment given by device-side
offsets, with an optional second group (one expert over its own rows: the
shared expert) in the same launch; :func:`moe_route_kernel` one launch of
the layer's routing (the fp32 router product, softmax, top-k,
renormalisation and the stable sort of the pairs by expert);
:func:`moe_combine_kernel` one launch of the weighted combine.  All are
sized from shapes alone, so a CUDA graph can hold them; the expert kernel
and the per-token part of the routing are row-invariant (a row's result
depends only on that row), and the combine is elementwise.

``kernels/csrc/moe_backward.cu`` holds the backward kernels, behind five
wrappers: :func:`moe_combine_backward_kernel` (dys and dweights),
:func:`moe_down_grad_kernel` and :func:`moe_up_grad_kernel` (the grouped
data gradient's two launches: the down launch's with the activation's
backward in its epilogue, then the gate/up launch's),
:func:`moe_weight_grad_kernel` (every expert weight's gradient in one
launch) and :func:`moe_route_backward_kernel` (two launches: dlogits once a
token with dx, then dw; one call counted); the row gather's backward is
:func:`moe_combine_kernel` with unit weights.  None uses a floating-point
atomic: two launches are bitwise equal.  Each is sized from shapes alone.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (:mod:`.ref`), CUDA tensors launch the kernel or raise.
The forward wrappers refuse, on the card, inputs that require grad: their
backward runs only through ``ops.MoEFFN``.
``moe_experts_kernel.launches`` counts launches (``launches_by_mode`` per
epilogue mode, ``launches_by_route`` per route: every launch is ``wgmma``,
on tiles of the rows the library's own plan picks, :func:`library_plan`),
``moe_route_kernel.launches`` (calls: one or two launches) and
``moe_combine_kernel.launches`` theirs (``launches_by_mode``: the bf16
output, or the fp32 partial of an expert shard under a mesh),
never plain-version calls; a CUDA graph's replay adds the launches it
holds (``serve/graphs.py``).  The three forward wrappers also count each
launch in ``launches_by_kind`` under the step kind their caller set with
:func:`launch_kind` (the scheduler's decode steps, prefill chunks, ring
prefills and speculation's draft and verify steps; "other" outside
any).  Each backward wrapper counts its own.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..grad_guard import refuse_grad
from . import backward_plan, plan
from . import route_plan as route_model
from .ref import (MODES, Route, moe_combine_backward_plain, moe_combine_partial_plain,
                  moe_combine_plain,
                  moe_down_grad_plain, moe_experts_plain, moe_route_backward_plain,
                  moe_route_plain, moe_up_grad_plain, moe_weight_grad_plain)

ROUTES = ("wgmma_bm64", "wgmma_bm128")      # wgmma on tiles of 64 or 128 rows
ROUTE_COUNTERS = 256                        # kRouteCounters: int32 counters a device

KINDS = ("decode", "chunk", "prefill", "draft", "verify", "other")   # launch_kind's step kinds
_KIND = contextvars.ContextVar("moe_launch_kind", default="other")

_lib = None


@contextlib.contextmanager
def launch_kind(kind: str):
    """Within its scope the forward wrappers count their launches under
    ``kind`` in ``launches_by_kind``: "decode" (a decode step), "chunk" (a
    prefill chunk on a live cache), "prefill" (a from-scratch prefill into
    a fresh ring), "draft" (a speculation round's draft catch-up and draft
    steps), "verify" (its verify chunk) or "other"."""
    if kind not in KINDS:
        raise ValueError(f"launch kind {kind!r} is not one of {KINDS}")
    token = _KIND.set(kind)
    try:
        yield
    finally:
        _KIND.reset(token)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("moe_experts")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_experts_launch.argtypes = [i, p, p, i, i, p, p, p, i, i,
                                           p, i, p, p, p, i, i, p, p, p, p, p]
        lib.moe_experts_launch.restype = i
        lib.moe_experts_plan.argtypes = [i, i, i, i, i, i, p]
        lib.moe_experts_plan.restype = i
        lib.moe_route_plan.argtypes = [i, i, i, i, p]
        lib.moe_route_plan.restype = i
        lib.moe_route_launch.argtypes = [p] * 14 + [i, i, i, i, p]
        lib.moe_route_launch.restype = i
        lib.moe_combine_launch.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.moe_combine_launch.restype = i
        lib.moe_combine_partial_launch.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.moe_combine_partial_launch.restype = i
        lib.moe_experts_error_string.argtypes = [i]
        lib.moe_experts_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _dense(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check(mode, x, offsets, w1, w2, shared) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.ndim != 2 or w1.ndim != 3:
        raise ValueError(f"x must be (P, K) and w1 (E, K, N), got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}")
    E, K, N = w1.shape
    _dense("x", x, (x.shape[0], K), x.device)
    _dense("w1", w1, (E, K, N), x.device)
    if (mode == "swiglu") != (w2 is not None):
        raise ValueError(f"mode {mode!r} takes {'a' if mode == 'swiglu' else 'no'} w2")
    if w2 is not None:
        _dense("w2", w2, (E, K, N), x.device)
    if K % 8 or N % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8 (16-byte rows)")
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32 or \
            offsets.device != x.device or not offsets.is_contiguous():
        raise ValueError(f"offsets must be a contiguous ({E + 1},) int32 tensor on "
                         f"{x.device}, got {tuple(offsets.shape)} {offsets.dtype} on "
                         f"{offsets.device}")
    if shared is not None:
        xs, w1s, w2s = shared
        if xs.ndim != 2 or w1s.ndim != 2:
            raise ValueError(f"shared x must be (R, K) and w1 (K, N), got "
                             f"{tuple(xs.shape)}, {tuple(w1s.shape)}")
        Ks, Ns = w1s.shape
        _dense("shared x", xs, (xs.shape[0], Ks), x.device)
        _dense("shared w1", w1s, (Ks, Ns), x.device)
        if (mode == "swiglu") != (w2s is not None):
            raise ValueError(f"mode {mode!r}: the shared expert's w2 does not fit")
        if w2s is not None:
            _dense("shared w2", w2s, (Ks, Ns), x.device)
        if Ks % 8 or Ns % 8:
            raise ValueError(f"shared K={Ks} and N={Ns} must be multiples of 8")


def moe_experts_kernel(mode: str, x: torch.Tensor, offsets: torch.Tensor, w1: torch.Tensor,
                       w2: Optional[torch.Tensor] = None,
                       shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                              Optional[torch.Tensor]]] = None,
                       pre: Optional[Sequence[Optional[torch.Tensor]]] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch: ``mode`` in ``("swiglu", "gelu", "plain")``; x (P, K)
    bf16, rows in expert order; offsets (E + 1,) int32, expert e's rows
    ``[offsets[e], offsets[e + 1])``; w1 (and w2 for SwiGLU) (E, K, N) bf16
    -> (out (P, N) bf16, shared out (R, N_s) or None).  ``shared`` is
    ``(x_s (R, K_s), w1_s (K_s, N_s), w2_s or None)``.  ``pre`` = ``(a, b,
    a_s, b_s)`` (each an output-shaped bf16 tensor or None) takes the bf16
    pre-activations x.W1 and x.W2 of a SwiGLU or GELU launch for the
    backward; the output is the same with or without it."""
    if x.device.type == "cpu":
        return moe_experts_plain(mode, x, offsets, w1, w2, shared, pre)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts_kernel runs on cpu or cuda, not {x.device}")
    refuse_grad("moe_experts_kernel (the grouped expert FFN)", "1.7.2", x, w1, w2,
                *(shared or ()), via="ops.MoEFFN")
    _check(mode, x, offsets, w1, w2, shared)
    pa, pb, pa_s, pb_s = pre if pre is not None else (None,) * 4
    E, K, N = w1.shape
    P = x.shape[0]
    out = x.new_empty((P, N))
    xs = w1s = w2s = out_s = None
    R = Ks = Ns = 0
    if shared is not None:
        xs, w1s, w2s = shared
        R, (Ks, Ns) = xs.shape[0], w1s.shape
        out_s = x.new_empty((R, Ns))
    if P + R == 0:
        return out, out_s
    for name, t, rows, n in (("pre a", pa, P, N), ("pre b", pb, P, N),
                             ("shared pre a", pa_s, R, Ns), ("shared pre b", pb_s, R, Ns)):
        if t is not None:
            _dense(name, t, (rows, n), x.device)

    lib = _library()
    with torch.cuda.device(x.device):
        tile_rows = library_plan(mode, P, E, N, R, Ns).bm
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_experts_launch(MODES.index(mode), x.data_ptr(), offsets.data_ptr(), P, E,
                                     w1.data_ptr(), _ptr(w2), out.data_ptr(), K, N,
                                     _ptr(xs), R, _ptr(w1s), _ptr(w2s), _ptr(out_s), Ks, Ns,
                                     _ptr(pa), _ptr(pb), _ptr(pa_s), _ptr(pb_s), stream)
    if err != 0:
        msg = lib.moe_experts_error_string(err).decode()
        raise RuntimeError(f"moe_experts kernel ({mode}) launch failed for x {tuple(x.shape)}, "
                           f"w1 {tuple(w1.shape)}: {msg} ({err})")
    moe_experts_kernel.launches += 1
    moe_experts_kernel.launches_by_mode[mode] += 1
    moe_experts_kernel.launches_by_route[f"wgmma_bm{tile_rows}"] += 1
    moe_experts_kernel.launches_by_kind[_KIND.get()] += 1
    return out, out_s


moe_experts_kernel.launches = 0
moe_experts_kernel.launches_by_mode = dict.fromkeys(MODES, 0)
moe_experts_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
moe_experts_kernel.launches_by_kind = dict.fromkeys(KINDS, 0)


def library_plan(mode: str, rows0: int, n_exp: int, N0: int, rows1: int = 0,
                 N1: int = 0) -> plan.Plan:
    """The plan ``moe_experts_launch`` makes for these shapes on the current
    CUDA device (``moe_experts_plan``: the tile rows, ring stages, shared
    memory and grid), the one rule for all of them; :func:`.plan.make_plan`
    models it for the CPU tests."""
    out = (ctypes.c_int * 5)()
    err = _library().moe_experts_plan(MODES.index(mode), rows0, n_exp, N0, rows1, N1, out)
    if err != 0:
        raise ValueError(f"moe_experts_plan refused mode {mode!r}, rows {rows0}, {n_exp} "
                         f"experts ({err})")
    return plan.Plan(*out)


class RoutePlan(NamedTuple):
    """The shape of one ``moe_route`` call (``moe_route_plan``), modelled by
    :func:`.route_plan.route_shape`."""
    tile_tokens: int        # tokens a tile
    groups: int             # blocks a tile: its 32 slices of D split over them
    tiles: int
    smem: int               # dynamic shared memory bytes a block
    workspace: int          # bytes: the slices' partial sums (groups > 1) and tile counts
    thread_tokens: int      # tokens a thread accumulates (x 8 experts)
    slice_warps: int        # warps of a block on different slices at once
    stage_d: int            # d values of each slice a ring stage holds
    sort_blocks: int        # blocks of the second (sort) launch; 0: one tile, no second launch
    tma: int                # 1: stages loaded by TMA (for 16-byte aligned x and w), else cp.async


def route_plan(T: int, D: int, E: int, k: int) -> RoutePlan:
    """The launches ``moe_route_launch`` makes for these shapes on the
    current CUDA device: grid (tiles, groups) of 256 threads, and with more
    than one tile a sort launch, from shapes and the SM count alone."""
    if not route_model.accepts(T, D, E, k):
        raise ValueError(f"moe_route takes T >= 1, D even and <= 4096, 1 <= k <= E <= 128 "
                         f"and k <= 32; got T={T} D={D} E={E} k={k}")
    out = (ctypes.c_int * 10)()
    err = _library().moe_route_plan(T, D, E, k, out)
    if err != 0:
        raise RuntimeError(f"moe_route_plan refused T={T} D={D} E={E} k={k} ({err})")
    return RoutePlan(*out)


_counters: Dict[torch.device, torch.Tensor] = {}


def _route_counters(device: torch.device) -> torch.Tensor:
    """The device's last-block-done counters: zeroed once, left zero by
    every launch, at one address for the process (a graph reads the
    address it captured).  Launches on one device must not overlap."""
    c = _counters.get(device)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("moe_route_kernel's counters are allocated by its first launch "
                               f"on {device}, which must not be inside a CUDA graph capture")
        c = _counters[device] = torch.zeros(ROUTE_COUNTERS, dtype=torch.int32, device=device)
    return c


def moe_route_kernel(x: torch.Tensor, w: torch.Tensor, k: int,
                     forced: Optional[torch.Tensor] = None) -> Route:
    """One call (a routing launch, and a sort launch when the tokens span
    more than one tile; counted once in ``launches``): x (T, D) bf16, w (D,
    E) fp32, contiguous, and optionally ``forced`` (T, k) int32 experts ->
    the layer's :class:`~.ref.Route` (logits, gates, renormalised top-k
    weights and experts, and the stable sort of the T k pairs by expert)."""
    if x.device.type == "cpu":
        return moe_route_plain(x, w, k, forced)
    if x.device.type != "cuda":
        raise ValueError(f"moe_route_kernel runs on cpu or cuda, not {x.device}")
    refuse_grad("moe_route_kernel (the MoE router)", "1.7.2", x, w, via="ops.MoEFFN")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be (T, D) and w (D, E), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.float32:
        raise TypeError(f"x must be bfloat16 and w float32, got {x.dtype}, {w.dtype}")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous and on one device")
    if x.shape[1] % 2 or x.data_ptr() % 4:
        raise ValueError(f"moe_route reads x in bf16 pairs: D={x.shape[1]} must be even "
                         "and x 4-byte aligned")
    T, D = x.shape
    E = w.shape[1]
    P = T * k
    if forced is not None and (forced.shape != (T, k) or forced.dtype != torch.int32 or
                               forced.device != x.device or not forced.is_contiguous()):
        raise ValueError(f"forced must be a contiguous ({T}, {k}) int32 tensor on {x.device}, "
                         f"got {tuple(forced.shape)} {forced.dtype} on {forced.device}")
    f32 = torch.empty(2 * T * E + P, dtype=torch.float32, device=x.device)
    i32 = torch.empty(P + E + 1 + 4 * P, dtype=torch.int32, device=x.device)
    logits, gates = f32[:T * E].view(T, E), f32[T * E:2 * T * E].view(T, E)
    weights = f32[2 * T * E:].view(T, k)
    idx, offsets = i32[:P].view(T, k), i32[P:P + E + 1]
    order, tok, pos, rank = i32[P + E + 1:].view(4, P).unbind(0)
    out = Route(logits, gates, weights, idx, offsets, order, tok, pos, rank)
    if T == 0:
        return out._replace(offsets=offsets.zero_())
    lib = _library()
    with torch.cuda.device(x.device):
        plan = route_plan(T, D, E, k)
        workspace = torch.empty(plan.workspace, dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_route_launch(
            x.data_ptr(), w.data_ptr(), None if forced is None else forced.data_ptr(),
            *(t.data_ptr() for t in out), workspace.data_ptr(),
            _route_counters(x.device).data_ptr(), T, D, E, k, stream)
    if err != 0:
        msg = lib.moe_experts_error_string(err).decode()
        raise RuntimeError(f"moe_route kernel launch failed for x {tuple(x.shape)}, w "
                           f"{tuple(w.shape)}, k={k}: {msg} ({err})")
    moe_route_kernel.launches += 1
    moe_route_kernel.launches_by_kind[_KIND.get()] += 1
    return out


moe_route_kernel.launches = 0
moe_route_kernel.launches_by_kind = dict.fromkeys(KINDS, 0)


def moe_combine_kernel(ys: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                       kept: Optional[torch.Tensor] = None,
                       y_shared: Optional[torch.Tensor] = None, *,
                       partial: bool = False) -> torch.Tensor:
    """One launch: ys (P, D) bf16 in expert order, pos (P,) int32 each
    pair's sorted row, weights (T, k) fp32 with T k = P, kept (P,) bool or
    None, y_shared (T, D) bf16 or None -> out (T, D) bf16, bitwise
    :func:`~.ref.moe_combine_plain`.  ``partial``: out (T, D) fp32, the sum
    before its cast, with no shared row (an expert shard's part of the
    routed sum, which the caller all-reduces over the shards), bitwise
    :func:`~.ref.moe_combine_partial_plain`.  A pair whose ``kept`` is
    False is never read.  Both modes count in ``launches``, and each in
    ``launches_by_mode`` ("bf16", "fp32")."""
    if partial and y_shared is not None:
        raise ValueError("the partial combine adds no shared row: add it after the reduction")
    if ys.device.type == "cpu":
        if partial:
            return moe_combine_partial_plain(ys, pos, weights, kept)
        return moe_combine_plain(ys, pos, weights, kept, y_shared)
    if ys.device.type != "cuda":
        raise ValueError(f"moe_combine_kernel runs on cpu or cuda, not {ys.device}")
    refuse_grad("moe_combine_kernel (the MoE combine)", "1.7.2", ys, weights, y_shared,
                via="ops.MoEFFN")
    if ys.ndim != 2 or weights.ndim != 2:
        raise ValueError(f"ys must be (P, D) and weights (T, k), got {tuple(ys.shape)}, "
                         f"{tuple(weights.shape)}")
    T, k = weights.shape
    P, D = ys.shape
    _dense("ys", ys, (P, D), ys.device)
    if P != T * k or D % 8:
        raise ValueError(f"ys must hold T k = {T * k} rows of a width that is a multiple of 8, "
                         f"got {tuple(ys.shape)}")
    for name, t, dtype in (("pos", pos, torch.int32), ("weights", weights, torch.float32),
                           ("kept", kept, torch.bool)):
        if t is not None and (t.dtype != dtype or t.device != ys.device or
                              not t.is_contiguous() or t.numel() != P):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of {P} elements on "
                             f"{ys.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if y_shared is not None:
        _dense("y_shared", y_shared, (T, D), ys.device)
    out = ys.new_empty((T, D), dtype=torch.float32 if partial else ys.dtype)
    if T == 0:
        return out
    lib = _library()
    kept_ptr = None if kept is None else kept.data_ptr()
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream(ys.device).cuda_stream
        if partial:
            err = lib.moe_combine_partial_launch(ys.data_ptr(), pos.data_ptr(),
                                                 weights.data_ptr(), kept_ptr, out.data_ptr(),
                                                 T, D, k, stream)
        else:
            err = lib.moe_combine_launch(
                ys.data_ptr(), pos.data_ptr(), weights.data_ptr(), kept_ptr,
                None if y_shared is None else y_shared.data_ptr(), out.data_ptr(), T, D, k,
                stream)
    if err != 0:
        msg = lib.moe_experts_error_string(err).decode()
        raise RuntimeError(f"moe_combine kernel launch failed for ys {tuple(ys.shape)}, weights "
                           f"{tuple(weights.shape)}: {msg} ({err})")
    moe_combine_kernel.launches += 1
    moe_combine_kernel.launches_by_mode["fp32" if partial else "bf16"] += 1
    moe_combine_kernel.launches_by_kind[_KIND.get()] += 1
    return out


moe_combine_kernel.launches = 0
moe_combine_kernel.launches_by_mode = {"bf16": 0, "fp32": 0}
moe_combine_kernel.launches_by_kind = dict.fromkeys(KINDS, 0)


# ---------------------------------------------------------------------------
# The backward (kernels/csrc/moe_backward.cu)
# ---------------------------------------------------------------------------

RB_COUNTERS = 256                           # kRbCounters: int32 counters a device

_blib = None


def _backward_library() -> ctypes.CDLL:
    global _blib
    if _blib is None:
        from ..build import load

        lib = load("moe_backward")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_combine_backward_launch.argtypes = [p] * 7 + [i, i, i, p]
        lib.moe_data_grad_launch.argtypes = [i, p, p, p]
        lib.moe_weight_grad_launch.argtypes = [p, p, i, p]
        lib.moe_data_grad_plan.argtypes = [i] * 6 + [p]
        lib.moe_weight_grad_plan.argtypes = [p, i, p]
        lib.moe_route_backward_plan.argtypes = [i] * 4 + [p]
        lib.moe_route_backward_launch.argtypes = [p] * 11 + [i] * 4 + [p]
        for f in ("moe_combine_backward_launch", "moe_data_grad_launch",
                  "moe_weight_grad_launch", "moe_data_grad_plan", "moe_weight_grad_plan",
                  "moe_route_backward_plan", "moe_route_backward_launch"):
            getattr(lib, f).restype = i
        lib.moe_backward_error_string.argtypes = [i]
        lib.moe_backward_error_string.restype = ctypes.c_char_p
        _blib = lib
    return _blib


def _raise(kernel: str, err: int, what: str) -> None:
    if err != 0:
        msg = _backward_library().moe_backward_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed for {what}: {msg} ({err})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on_card(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")


def _offsets_ok(offsets: torch.Tensor, E: int, device) -> None:
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32 or \
            offsets.device != device or not offsets.is_contiguous():
        raise ValueError(f"offsets must be a contiguous ({E + 1},) int32 tensor on {device}, got "
                         f"{tuple(offsets.shape)} {offsets.dtype} on {offsets.device}")


def moe_combine_backward_kernel(dout: torch.Tensor, ys: torch.Tensor, pos: torch.Tensor,
                                weights: torch.Tensor, kept: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch: the combine's backward at dout (T, D) bf16, from ys (P,
    D) bf16 (sorted order), pos (P,) int32, weights (T, k) fp32, kept (P,)
    bool or None -> (dys (P, D) bf16 in sorted order, dweights (T, k)
    fp32), both bitwise :func:`~.ref.moe_combine_backward_plain`."""
    if ys.device.type == "cpu":
        return moe_combine_backward_plain(dout, ys, pos, weights, kept)
    _on_card("moe_combine_backward_kernel", ys)
    if ys.ndim != 2 or weights.ndim != 2:
        raise ValueError(f"ys must be (P, D) and weights (T, k), got {tuple(ys.shape)}, "
                         f"{tuple(weights.shape)}")
    T, k = weights.shape
    P, D = ys.shape
    _dense("ys", ys, (P, D), ys.device)
    _dense("dout", dout, (T, D), ys.device)
    if P != T * k or D % 8:
        raise ValueError(f"ys must hold T k = {T * k} rows of a width that is a multiple of 8, "
                         f"got {tuple(ys.shape)}")
    for name, t, dtype in (("pos", pos, torch.int32), ("weights", weights, torch.float32),
                           ("kept", kept, torch.bool)):
        if t is not None and (t.dtype != dtype or t.device != ys.device or
                              not t.is_contiguous() or t.numel() != P):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of {P} elements on "
                             f"{ys.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    dys = torch.empty_like(ys)
    dweights = torch.empty_like(weights)
    if T == 0:
        return dys, dweights
    lib = _backward_library()
    with torch.cuda.device(ys.device):
        err = lib.moe_combine_backward_launch(
            dout.data_ptr(), ys.data_ptr(), pos.data_ptr(), weights.data_ptr(), _ptr(kept),
            dys.data_ptr(), dweights.data_ptr(), T, D, k, _stream(ys.device))
    _raise("moe_combine_backward", err, f"ys {tuple(ys.shape)}, weights {tuple(weights.shape)}")
    moe_combine_backward_kernel.launches += 1
    return dys, dweights


moe_combine_backward_kernel.launches = 0


def data_grad_plan(epi: str, rows0: int, n_exp: int, N0: int, rows1: int = 0,
                   N1: int = 0) -> backward_plan.DataGradPlan:
    """The plan ``moe_data_grad_launch`` makes for epilogue ``epi`` (in
    MODES) and these shapes on the current CUDA device
    (``moe_data_grad_plan``: tile rows, ring stages, shared memory, grid);
    :func:`.backward_plan.data_grad_plan` models it for the CPU tests."""
    out = (ctypes.c_int * 5)()
    err = _backward_library().moe_data_grad_plan(MODES.index(epi), rows0, n_exp, N0, rows1, N1,
                                                 out)
    if err != 0:
        raise ValueError(f"moe_data_grad_plan refused epilogue {epi!r}, rows {rows0}, {n_exp} "
                         f"experts ({err})")
    return backward_plan.DataGradPlan(*out)


def weight_grad_plan(dims: Sequence[Tuple[int, int, int, int]]) -> backward_plan.WeightGradPlan:
    """The plan ``moe_weight_grad_launch`` makes for jobs of ``(rows, n_exp,
    M, N)`` on the current CUDA device (``moe_weight_grad_plan``);
    :func:`.backward_plan.weight_grad_plan` models it."""
    flat = (ctypes.c_int * (4 * len(dims)))(*[v for d in dims for v in d])
    out = (ctypes.c_int * 4)()
    err = _backward_library().moe_weight_grad_plan(flat, len(dims), out)
    if err != 0:
        raise ValueError(f"moe_weight_grad_plan refused jobs {list(dims)} ({err})")
    return backward_plan.WeightGradPlan(*out)


def _data_grad_launch(epi: str, groups: List[tuple], device) -> None:
    """One data-gradient launch with epilogue ``epi`` (in MODES: SwiGLU or
    GELU backward, or plain); groups: up to two ``(g0, g1, w0, w1,
    offsets, pre_a, pre_b, out0, out1, rows, n_exp, N, K)``."""
    ptrs = (ctypes.c_void_p * 18)()
    dims = (ctypes.c_int * 8)()
    for gi, grp in enumerate(groups):
        for j, t in enumerate(grp[:9]):
            ptrs[9 * gi + j] = _ptr(t)
        for j, v in enumerate(grp[9:]):
            dims[4 * gi + j] = v
    lib = _backward_library()
    with torch.cuda.device(device):
        err = lib.moe_data_grad_launch(MODES.index(epi), ptrs, dims, _stream(device))
    _raise(f"moe_data_grad ({epi})", err, f"groups {[g[9:] for g in groups]}")


def moe_down_grad_kernel(mode: str, dy: torch.Tensor, offsets: torch.Tensor,
                         w_down: torch.Tensor, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                         shared: Optional[Tuple] = None):
    """One launch of the grouped data gradient with the activation's
    backward in its epilogue: per segment ``dh = dy . W_d[e]^T`` (dy (P,
    D) bf16 in expert order, W_d (E, F, D) bf16, offsets (E + 1,) int32),
    then SwiGLU's (``mode="swiglu"``: the gate/up pre-activations a, b (P,
    F)) or GELU's (a) backward -> ``(da, db or None, (da_s, db_s) or
    None)``; ``shared = (dy_s (R, D), W_d_s (F_s, D), a_s, b_s)``, a SwiGLU
    shared expert, rides as a second group.  Within the stated bound of
    :func:`~.ref.moe_down_grad_plain`."""
    if shared is not None and mode != "swiglu":
        raise NotImplementedError("a shared expert beside GELU experts is not ported "
                                  "(no configuration has one)")
    if dy.device.type == "cpu":
        return moe_down_grad_plain(mode, dy, offsets, w_down, a, b, shared)
    _on_card("moe_down_grad_kernel", dy)
    if mode not in ("swiglu", "gelu") or (mode == "swiglu") != (b is not None):
        raise ValueError(f"mode must be swiglu (with b) or gelu (without), got {mode!r}")
    if dy.ndim != 2 or w_down.ndim != 3:
        raise ValueError(f"dy must be (P, D) and w_down (E, F, D), got {tuple(dy.shape)}, "
                         f"{tuple(w_down.shape)}")
    E, F, D = w_down.shape
    P = dy.shape[0]
    dev = dy.device
    _offsets_ok(offsets, E, dev)
    for name, t, shape in (("dy", dy, (P, D)), ("w_down", w_down, (E, F, D)), ("a", a, (P, F)),
                           ("b", b, (P, F))):
        if t is not None:
            _dense(name, t, shape, dev)
    da = torch.empty_like(a)
    db = None if b is None else torch.empty_like(b)
    groups = [(dy, None, w_down, None, offsets, a, b, da, db, P, E, F, D)]
    out_s = None
    if shared is not None:
        dy_s, w_s, a_s, b_s = shared
        R = dy_s.shape[0]
        Fs = w_s.shape[0]
        for name, t, shape in (("shared dy", dy_s, (R, D)), ("shared w_down", w_s, (Fs, D)),
                               ("shared a", a_s, (R, Fs)), ("shared b", b_s, (R, Fs))):
            _dense(name, t, shape, dev)
        out_s = (torch.empty_like(a_s), torch.empty_like(b_s))
        if R > 0:
            groups.append((dy_s, None, w_s, None, None, a_s, b_s, out_s[0], out_s[1], R, 1, Fs,
                           D))
    if P + (0 if shared is None else shared[0].shape[0]) > 0:
        _data_grad_launch(mode, groups, dev)
        moe_down_grad_kernel.launches += 1
    return da, db, out_s


moe_down_grad_kernel.launches = 0


def moe_up_grad_kernel(da: torch.Tensor, db: Optional[torch.Tensor], offsets: torch.Tensor,
                       w1: torch.Tensor, w2: Optional[torch.Tensor] = None,
                       shared: Optional[Tuple] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the grouped data gradient of the gate/up launch: per
    segment ``dx = da . W1[e]^T + db . W2[e]^T`` (da, db (P, F) bf16; W1,
    W2 (E, D, F) bf16: w_gate and w_up; GELU: da . W_up^T alone) in one
    fp32 accumulation, rounded once -> (dx (P, D), dx_s or None);
    ``shared = (da_s, db_s, W1_s (D, F_s), W2_s)``, a SwiGLU shared expert,
    rides as a second group.  Within the stated bound of
    :func:`~.ref.moe_up_grad_plain`."""
    if shared is not None and db is None:
        raise NotImplementedError("a shared expert beside GELU experts is not ported "
                                  "(no configuration has one)")
    if da.device.type == "cpu":
        return moe_up_grad_plain(da, db, offsets, w1, w2, shared)
    _on_card("moe_up_grad_kernel", da)
    if (db is None) != (w2 is None) or da.ndim != 2 or w1.ndim != 3:
        raise ValueError(f"da (P, F) and W1 (E, D, F), with db and W2 both or neither; got "
                         f"{tuple(da.shape)}, {tuple(w1.shape)}")
    E, D, F = w1.shape
    P = da.shape[0]
    dev = da.device
    _offsets_ok(offsets, E, dev)
    for name, t, shape in (("da", da, (P, F)), ("db", db, (P, F)), ("w1", w1, (E, D, F)),
                           ("w2", w2, (E, D, F))):
        if t is not None:
            _dense(name, t, shape, dev)
    dx = da.new_empty((P, D))
    groups = [(da, db, w1, w2, offsets, None, None, dx, None, P, E, D, F)]
    dx_s = None
    if shared is not None:
        da_s, db_s, w1_s, w2_s = shared
        R, Fs = da_s.shape
        for name, t, shape in (("shared da", da_s, (R, Fs)), ("shared db", db_s, (R, Fs)),
                               ("shared w1", w1_s, (D, Fs)), ("shared w2", w2_s, (D, Fs))):
            _dense(name, t, shape, dev)
        dx_s = da.new_empty((R, D))
        if R > 0:
            groups.append((da_s, db_s, w1_s, w2_s, None, None, None, dx_s, None, R, 1, D, Fs))
    if P + (0 if dx_s is None else dx_s.shape[0]) > 0:
        _data_grad_launch("plain", groups, dev)
        moe_up_grad_kernel.launches += 1
    return dx, dx_s


moe_up_grad_kernel.launches = 0

MAX_WEIGHT_JOBS = 6


def moe_weight_grad_kernel(jobs: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                Optional[torch.Tensor]]]) -> List[torch.Tensor]:
    """One launch for up to six weight gradients: each job ``(a (rows, M),
    b (rows, N), offsets (E + 1,) int32 or None)`` gives ``out[e] = a[seg
    e]^T . b[seg e]`` (E, M, N) bf16, fp32 accumulation over the segment's
    rows in order, one rounding (zeros for an empty segment); without
    offsets one product over all rows, (M, N).  Within the stated bound of
    :func:`~.ref.moe_weight_grad_plain`.  Jobs run in the order given: put
    the longest segments first."""
    if not jobs or len(jobs) > MAX_WEIGHT_JOBS:
        raise ValueError(f"moe_weight_grad_kernel takes 1 to {MAX_WEIGHT_JOBS} jobs, "
                         f"got {len(jobs)}")
    a0 = jobs[0][0]
    if a0.device.type == "cpu":
        return [moe_weight_grad_plain(a, b, off) for a, b, off in jobs]
    _on_card("moe_weight_grad_kernel", a0)
    dev = a0.device
    outs = []
    ptrs = (ctypes.c_void_p * (4 * len(jobs)))()
    dims = (ctypes.c_int * (4 * len(jobs)))()
    for i, (a, b, off) in enumerate(jobs):
        if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
            raise ValueError(f"job {i}: a (rows, M) and b (rows, N), got {tuple(a.shape)}, "
                             f"{tuple(b.shape)}")
        rows, M = a.shape
        N = b.shape[1]
        _dense(f"job {i} a", a, (rows, M), dev)
        _dense(f"job {i} b", b, (rows, N), dev)
        if M % 8 or N % 8:
            raise ValueError(f"job {i}: M={M} and N={N} must be multiples of 8")
        E = 1
        if off is not None:
            E = off.shape[0] - 1
            _offsets_ok(off, E, dev)
        out = a.new_empty((E, M, N) if off is not None else (M, N))
        outs.append(out)
        for j, t in enumerate((a, b, out, off)):
            ptrs[4 * i + j] = _ptr(t)
        for j, v in enumerate((rows, E, M, N)):
            dims[4 * i + j] = v
    lib = _backward_library()
    with torch.cuda.device(dev):
        err = lib.moe_weight_grad_launch(ptrs, dims, len(jobs), _stream(dev))
    _raise("moe_weight_grad", err, f"jobs {[tuple(d) for d in zip(*[iter(dims)] * 4)]}")
    moe_weight_grad_kernel.launches += 1
    return outs


moe_weight_grad_kernel.launches = 0


class RouteBackwardPlan(NamedTuple):
    """The shape of one ``moe_route_backward`` call (two launches),
    modelled by :func:`.route_plan.route_backward_shape`."""
    token_tiles: int        # the dx launch's blocks: 64 tokens each
    dx_columns: int         # its columns of D a chunk
    dx_smem: int            # its dynamic shared memory bytes
    workspace: int          # bytes: the dlogits (T, E) and the dw splits' partials
    d_tiles: int            # the dw launch's tiles of D
    dw_columns: int         # its columns a tile
    splits: int             # its token splits (partials summed in split order)
    split_tokens: int       # tokens a split
    dw_threads: int         # its threads a block
    dw_smem: int            # its dynamic shared memory bytes


def route_backward_plan(T: int, D: int, E: int, k: int) -> RouteBackwardPlan:
    """The launches ``moe_route_backward_launch`` makes for these shapes,
    from shapes alone."""
    if not route_model.accepts(T, D, E, k):
        raise ValueError(f"moe_route_backward takes T >= 1, D even and <= 4096, 1 <= k <= E <= "
                         f"128 and k <= 32; got T={T} D={D} E={E} k={k}")
    out = (ctypes.c_int * 10)()
    err = _backward_library().moe_route_backward_plan(T, D, E, k, out)
    if err != 0:
        raise RuntimeError(f"moe_route_backward_plan refused T={T} D={D} E={E} k={k} ({err})")
    return RouteBackwardPlan(*out)


_rb_counters: Dict[torch.device, torch.Tensor] = {}


def moe_route_backward_kernel(x: torch.Tensor, w: torch.Tensor, gates: torch.Tensor,
                              weights: torch.Tensor, idx: torch.Tensor, dweights: torch.Tensor,
                              dgates: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing's backward at the gradients of its weights (T, k) fp32
    and gates (T, E) fp32 (or None), from x (T, D) bf16, w (D, E) fp32, the
    gates, weights and idx (T, k) int32 of the forward -> (dx (T, D) bf16,
    dw (D, E) fp32).  Two launches (dlogits once a token and dx, then dw),
    counted as one call in ``launches``; dx sums over the experts in order,
    dw over tokens in a fixed order (each split's tokens in order, the
    splits' partials in split order).  Within the stated bound of
    :func:`~.ref.moe_route_backward_plain`."""
    if x.device.type == "cpu":
        return moe_route_backward_plain(x, w, gates, weights, idx, dweights, dgates)
    _on_card("moe_route_backward_kernel", x)
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be (T, D) and w (D, E), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    T, D = x.shape
    E = w.shape[1]
    k = weights.shape[1] if weights.ndim == 2 else -1
    dev = x.device
    for name, t, dtype, shape in (("x", x, torch.bfloat16, (T, D)), ("w", w, torch.float32, (D, E)),
                                  ("gates", gates, torch.float32, (T, E)),
                                  ("weights", weights, torch.float32, (T, k)),
                                  ("idx", idx, torch.int32, (T, k)),
                                  ("dweights", dweights, torch.float32, (T, k)),
                                  ("dgates", dgates, torch.float32, (T, E))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if D % 2 or x.data_ptr() % 4:
        raise ValueError(f"moe_route_backward reads x in bf16 pairs: D={D} must be even and x "
                         "4-byte aligned")
    dx = x.new_empty((T, D))
    dw = w.new_empty((D, E))
    if T == 0:
        return dx, dw.zero_()
    lib = _backward_library()
    with torch.cuda.device(dev):
        plan = route_backward_plan(T, D, E, k)
        ws = torch.empty(plan.workspace, dtype=torch.uint8, device=dev)
        c = _rb_counters.get(dev)
        if c is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("moe_route_backward_kernel's counters are allocated by its "
                                   f"first launch on {dev}, which must not be inside a capture")
            c = _rb_counters[dev] = torch.zeros(RB_COUNTERS, dtype=torch.int32, device=dev)
        err = lib.moe_route_backward_launch(
            x.data_ptr(), w.data_ptr(), gates.data_ptr(), weights.data_ptr(), idx.data_ptr(),
            dweights.data_ptr(), _ptr(dgates), dx.data_ptr(), dw.data_ptr(),
            ws.data_ptr(), c.data_ptr(), T, D, E, k, _stream(dev))
    _raise("moe_route_backward", err, f"x {tuple(x.shape)}, w {tuple(w.shape)}, k={k}")
    moe_route_backward_kernel.launches += 1
    return dx, dw


moe_route_backward_kernel.launches = 0
