"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel's wrapper.

The kernel (``kernels/csrc/ssd_scan.cu``) enters from ``h0`` and returns
the final state.  It has two routes, chosen from the dtype and the dims
alone by the rule that ``ssd_scan.cu`` states once (``route_of``, exported
as ``ssd_scan_route``; :func:`route` asks the built library):

* ``"tensor_core"``: bfloat16 with P a multiple of 16 and N 64, 128 or 256
  (mamba2-1.3b's P = 64, N = 128, prefill and decode alike).  For L >= 2,
  one block per (head, 32 or 16 rows of P, batch row) walks 128-token
  chunks (64 at N = 256) with its slab of the fp32 state in registers; the
  products run on mma.sync with bf16 operands, the fp32 operands (the
  decayed C.B^T weights, h_prev and x * wend) as bf16 hi + lo pairs, so
  ``y`` departs from the fp32 plain version by about one bf16 rounding
  (:func:`.ref.bf16_rounding_bound`).  L = 1 (a decode step) streams each
  state row once in fp32 with 16-byte loads.
* ``"cuda_core"``: float32, and bfloat16 at any other P or N.  One block
  per (b, head) over chunks of up to 64 tokens with the (P, N) fp32 state
  in shared memory, fp32 arithmetic throughout.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (:func:`.ref.ssd_scan_plain`, chunked by ``chunk``), CUDA
tensors launch the kernel or raise.  ``ssd_scan_kernel.launches`` counts
kernel launches (never plain-version calls; a CUDA graph's replay adds
the launches it holds, ``serve/graphs.py``), and
``ssd_scan_kernel.launches_by_route`` counts them per route.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .ref import ssd_scan_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("cuda_core", "tensor_core")        # index = the C interface's route code
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_route.argtypes = [i, i, i]
        lib.ssd_scan_route.restype = i
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def route(dtype: torch.dtype, P: int, N: int) -> str:
    """The kernel route a call of this dtype, head dim P and state dim N
    takes, as the built library's ``ssd_scan_route`` gives it: bf16 with P
    a multiple of 16 and N 64, 128 or 256 on the tensor cores, everything
    else on the CUDA cores.  Nothing else (no length, no failure) picks the
    route.  Needs the library, so the card's toolchain."""
    return ROUTES[_library().ssd_scan_route(_DTYPE_CODE[dtype], P, N)]


def _check(x, dt, A, Bm, Cm, h0) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, L, H, P), got {tuple(x.shape)}")
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1] if Bm.ndim == 3 else -1
    want = {"dt": (dt, (Bsz, L, H)), "A": (A, (H,)), "Bm": (Bm, (Bsz, L, N)),
            "Cm": (Cm, (Bsz, L, N))}
    if h0 is not None:
        want["h0"] = (h0, (Bsz, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must share float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm) + ((h0,) if h0 is not None else ())):
        raise ValueError("x, dt, A, Bm, Cm and h0 must be contiguous")
    if Bsz > 65535:
        raise ValueError(f"batch {Bsz} exceeds the grid's limit 65535")


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                    chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P) and Bm, Cm (B, L, N), one dtype (float32 or
    bfloat16); dt (B, L, H), A (H,) and h0 (B, H, P, N) or None, float32;
    all contiguous -> ``(y (B, L, H, P) in x's dtype, h_final (B, H, P, N)
    float32)``.  ``chunk`` is the plain version's chunk length (CPU
    tensors); the kernel picks its own (128 or 64 tokens on the tensor-core
    route, up to 64 on the CUDA-core route), which changes only the
    rounding."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_kernel runs on cpu or cuda, not {x.device}")
    _check(x, dt, A, Bm, Cm, h0)
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    h_final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or N == 0:
        if h0 is not None:
            h_final.copy_(h0)
        else:
            h_final.zero_()
        return y, h_final
    path = route(x.dtype, P, N)
    if path == "tensor_core" and any(
            t.data_ptr() % 16 for t in (x, Bm, Cm) + ((h0,) if h0 is not None else ())):
        raise ValueError("the tensor-core route copies x, Bm, Cm and h0 by 16 bytes: their "
                         "data must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), Bsz, L, H, P, N, stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel ({path}) launch failed for x {tuple(x.shape)}, "
                           f"N={N}: {msg} ({err})")
    ssd_scan_kernel.launches += 1
    ssd_scan_kernel.launches_by_route[path] += 1
    return y, h_final


ssd_scan_kernel.launches = 0
ssd_scan_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
