"""RG-LRU diagonal linear recurrence: the hand-written CUDA kernel's wrapper.

The kernel (``kernels/csrc/rglru_scan.cu``) runs one lane per ``(b, w)``
channel, each walking the sequence with its state in a register; a warp of
32 channels streams a and b through a 4-stage cp.async ring of 32 steps
(calls shorter than a stage, and rows that are not whole 16-byte chunks,
load each step directly).  Its fp32 result is bitwise the plain left fold
(:func:`.ref.rglru_scan_plain`).

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version, CUDA tensors launch the kernel or raise.
``rglru_scan_kernel.launches`` counts kernel launches (never plain-version
calls; a CUDA graph's replay adds the launches it holds,
``serve/graphs.py``), and ``rglru_scan_kernel.launches_by_kernel`` counts them per kernel
(``"staged"`` or ``"direct"``), as the library's ``rglru_scan_kernel_of``
names the one it runs.
"""

from __future__ import annotations

import ctypes

import torch

from .ref import rglru_scan_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = ("direct", "staged")          # index = rglru_scan_kernel_of's answer
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("rglru_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [i, p, p, p, i, i, i, p]
        lib.rglru_scan_launch.restype = i
        lib.rglru_scan_kernel_of.argtypes = [i, i, i, p, p]
        lib.rglru_scan_kernel_of.restype = i
        lib.rglru_scan_error_string.argtypes = [i]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, L, W), float32 or bfloat16, same dtype, contiguous ->
    h (B, L, W) in that dtype, ``h_t = a_t * h_{t-1} + b_t`` from zero."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_kernel runs on cpu or cuda, not {a.device}")
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must share one (B, L, W) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    B, L, W = a.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's y limit 65535")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_launch(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
                                    h.data_ptr(), B, L, W, stream)
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan kernel launch failed: {msg} ({err})")
    kernel = KERNELS[lib.rglru_scan_kernel_of(_DTYPE_CODE[a.dtype], L, W, a.data_ptr(),
                                              b.data_ptr())]
    rglru_scan_kernel.launches += 1
    rglru_scan_kernel.launches_by_kernel[kernel] += 1
    return h


rglru_scan_kernel.launches = 0
rglru_scan_kernel.launches_by_kernel = dict.fromkeys(KERNELS, 0)
