"""Grouped expert FFN and router product: the hand-written CUDA kernels' wrappers.

``kernels/csrc/moe_experts.cu`` holds both.  :func:`moe_experts_kernel`
runs one launch of the grouped expert product over the routed (token,
expert) pairs sorted by expert, each expert's segment given by device-side
offsets, with an optional second group (one expert over its own rows: the
shared expert) in the same launch; :func:`moe_router_kernel` the fp32
router product.  Both are row-invariant (a row's result depends only on
that row) and sized from shapes alone, so a CUDA graph can hold them.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (:mod:`.ref`), CUDA tensors launch the kernel or raise.
``moe_experts_kernel.launches`` counts launches (``launches_by_mode`` per
epilogue mode, ``launches_by_route`` per route: every launch is ``wgmma``,
on tiles of the rows the library's own plan picks, :func:`library_plan`)
and ``moe_router_kernel.launches`` the router's, never plain-version calls;
a CUDA graph's replay adds the launches it holds (``serve/graphs.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import plan
from .ref import MODES, moe_experts_plain, moe_router_plain

ROUTES = ("wgmma_bm64", "wgmma_bm128")      # wgmma on tiles of 64 or 128 rows

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("moe_experts")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_experts_launch.argtypes = [i, p, p, i, i, p, p, p, i, i,
                                           p, i, p, p, p, i, i, p]
        lib.moe_experts_launch.restype = i
        lib.moe_experts_plan.argtypes = [i, i, i, i, i, i, p]
        lib.moe_experts_plan.restype = i
        lib.moe_router_launch.argtypes = [p, p, p, i, i, i, p]
        lib.moe_router_launch.restype = i
        lib.moe_experts_error_string.argtypes = [i]
        lib.moe_experts_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
                                              Optional[torch.Tensor]]] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch: ``mode`` in ``("swiglu", "gelu", "plain")``; x (P, K)
    bf16, rows in expert order; offsets (E + 1,) int32, expert e's rows
    ``[offsets[e], offsets[e + 1])``; w1 (and w2 for SwiGLU) (E, K, N) bf16
    -> (out (P, N) bf16, shared out (R, N_s) or None).  ``shared`` is
    ``(x_s (R, K_s), w1_s (K_s, N_s), w2_s or None)``."""
    if x.device.type == "cpu":
        return moe_experts_plain(mode, x, offsets, w1, w2, shared)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts_kernel runs on cpu or cuda, not {x.device}")
    _check(mode, x, offsets, w1, w2, shared)
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _library()
    with torch.cuda.device(x.device):
        tile_rows = library_plan(mode, P, E, N, R, Ns).bm
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_experts_launch(MODES.index(mode), x.data_ptr(), offsets.data_ptr(), P, E,
                                     w1.data_ptr(), ptr(w2), out.data_ptr(), K, N,
                                     ptr(xs), R, ptr(w1s), ptr(w2s), ptr(out_s), Ks, Ns,
                                     stream)
    if err != 0:
        msg = lib.moe_experts_error_string(err).decode()
        raise RuntimeError(f"moe_experts kernel ({mode}) launch failed for x {tuple(x.shape)}, "
                           f"w1 {tuple(w1.shape)}: {msg} ({err})")
    moe_experts_kernel.launches += 1
    moe_experts_kernel.launches_by_mode[mode] += 1
    moe_experts_kernel.launches_by_route[f"wgmma_bm{tile_rows}"] += 1
    return out, out_s


moe_experts_kernel.launches = 0
moe_experts_kernel.launches_by_mode = dict.fromkeys(MODES, 0)
moe_experts_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


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


def moe_router_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (T, D) bf16, w (D, E) fp32, contiguous -> logits (T, E) fp32, each a
    fixed-order fp32 sum (never TF32)."""
    if x.device.type == "cpu":
        return moe_router_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_router_kernel runs on cpu or cuda, not {x.device}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be (T, D) and w (D, E), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.float32:
        raise TypeError(f"x must be bfloat16 and w float32, got {x.dtype}, {w.dtype}")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous and on one device")
    if x.shape[1] % 2 or x.data_ptr() % 4:
        raise ValueError(f"the router reads x in bf16 pairs: D={x.shape[1]} must be even "
                         "and x 4-byte aligned")
    T, D = x.shape
    E = w.shape[1]
    out = torch.empty((T, E), dtype=torch.float32, device=x.device)
    if T == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_router_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), T, D, E, stream)
    if err != 0:
        msg = lib.moe_experts_error_string(err).decode()
        raise RuntimeError(f"moe_router kernel launch failed for x {tuple(x.shape)}, w "
                           f"{tuple(w.shape)}: {msg} ({err})")
    moe_router_kernel.launches += 1
    return out


moe_router_kernel.launches = 0
