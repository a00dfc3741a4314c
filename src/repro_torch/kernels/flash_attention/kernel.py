"""Flash attention: the hand-written CUDA kernel's wrapper.

The kernel (``kernels/csrc/flash_attention.cu``) runs the kv loop inside
one block per (q tile, head, batch row) and reads the model's layout
directly, indexing the kv head of each query head's group.  It has two
routes, chosen by :func:`route` from the dtype and the head dim alone:

* ``"tensor_core"``: bfloat16 with D a multiple of 16 (every main-path
  shape).  128-row q tiles (64 at D > 128), mma.sync on bf16 tiles staged
  by cp.async, fp32 softmax state, P rounded to bf16 for P.V.
* ``"cuda_core"``: float32 (TF32 would break its 2e-4 contract), and
  bfloat16 at any other D (the sweeps' D = 8).  64-row q tiles staged as
  fp32, fp32 arithmetic throughout.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (:func:`.ref.flash_attention_plain`), CUDA tensors launch
the kernel or raise.  ``flash_attention_kernel.launches`` counts kernel
launches (never plain-version calls; a CUDA graph's replay adds the
launches it holds, ``serve/graphs.py``), and
``flash_attention_kernel.launches_by_route`` counts them per route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .ref import flash_attention_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("cuda_core", "tensor_core")        # index = the C interface's route code
MAX_HEAD_DIM = 256
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel route a call of this dtype and head dim takes: bf16 at a
    multiple of 16 runs on the tensor cores, everything else on the CUDA
    cores.  Nothing else (no shape, no failure) picks the route."""
    return "tensor_core" if dtype == torch.bfloat16 and head_dim % 16 == 0 else "cuda_core"


def _check(q, k, v, t_real, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, D) and k, v one (B, T, Hkv, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(batch, head dim, H a multiple of Hkv)")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside the kernel's 1..{MAX_HEAD_DIM}")
    if not 1 <= t_real <= T:
        raise ValueError(f"t_real {t_real} outside 1..T={T}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} exceed the grid's limit 65535")
    if route(q.dtype, D) == "tensor_core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core route copies q, k and v by 16 bytes: their data "
                         "must be 16-byte aligned")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, window: Optional[int] = None,
                           t_real: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D); one dtype (float32 or bfloat16),
    contiguous -> o (B, S, H, D) in that dtype.  Row i attends key j iff
    ``j < t_real`` (default T), ``j <= i`` when ``causal``, and ``j > i -
    window`` when ``window`` is set; a row with no such key gets the mean of
    v over the ``t_real`` rows."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, t_real=t_real)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel runs on cpu or cuda, not {q.device}")
    t_real = k.shape[1] if t_real is None else t_real
    _check(q, k, v, t_real, window)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if S == 0:
        return o
    path = route(q.dtype, D)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            ROUTES.index(path), _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(),
            B, S, T, H, Hkv, D, t_real, int(causal), window or 0, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel ({path}) launch failed for q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}: {msg} ({err})")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by_route[path] += 1
    return o


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
