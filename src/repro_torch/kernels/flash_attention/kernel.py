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

The forward can also return each row's log-sum-exp (``return_lse``);
:func:`flash_attention_backward_kernel` takes it with the output gradient
and runs the FlashAttention-2 backward of an aligned causal self-attention
(optionally windowed) on the same route as the forward, in one of three
designs that the library's ``flash_attention_backward_kernel_of`` names
from the dtype and D (:data:`DESIGNS`):

* ``"wgmma"`` (bf16 at D = 64, 128, 256: every trained head dim): two
  launches, dQ first (it also forms delta = rowsum(dO o)), then dK/dV;
  warp-specialised blocks, TMA rings, wgmma with the second products' A
  operand in registers (``kernels/flash_attention/plan.py`` models the
  walks);
* ``"mma_sync"`` (bf16 at other multiples of 16) and ``"cuda_core"``
  (float32, and bf16 at other D): three launches, the delta pre-pass, one
  dK/dV block per kv tile and kv head, one dQ block per q tile and head.

Each design sums GQA's group inside a block, adds nothing atomically and
writes every element once, so two launches are bitwise equal.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (:func:`.ref.flash_attention_plain`,
:func:`.ref.flash_attention_backward_plain`), CUDA tensors launch the
kernel or raise.  ``flash_attention_kernel.launches`` counts forward
launches and ``flash_attention_backward_kernel.launches`` backward calls
(never plain-version calls; a CUDA graph's replay adds the launches it
holds, ``serve/graphs.py``), and ``.launches_by_route`` counts each per
route; the backward's ``.launches_by_design`` counts its calls per design.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .ref import flash_attention_backward_plain, flash_attention_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("cuda_core", "tensor_core")        # index = the C interface's route code
DESIGNS = ("cuda_core", "mma_sync", "wgmma")  # index = flash_attention_backward_kernel_of's answer
PLAN_FIELDS = ("kv_rows", "q_tile", "split_columns", "q_rows", "kv_tile", "kv_stages",
               "q_stages")
MAX_HEAD_DIM = 256
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_backward_launch.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p,
                                                        i, i, i, i, i, i, p]
        lib.flash_attention_backward_launch.restype = i
        lib.flash_attention_backward_kernel_of.argtypes = [i, i]
        lib.flash_attention_backward_kernel_of.restype = i
        lib.flash_attention_backward_plan.argtypes = [i, p]
        lib.flash_attention_backward_plan.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel route a call of this dtype and head dim takes: bf16 at a
    multiple of 16 runs on the tensor cores, everything else on the CUDA
    cores.  Nothing else (no shape, no failure) picks the route."""
    return "tensor_core" if dtype == torch.bfloat16 and head_dim % 16 == 0 else "cuda_core"


def library_plan(head_dim: int) -> Optional[dict]:
    """The wgmma backward's tiles at this head dim as the built library
    states them (``flash_attention_backward_plan``; :data:`PLAN_FIELDS`),
    or None where that design does not take D.  Needs the card's build."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    if _library().flash_attention_backward_plan(head_dim, out) != 0:
        return None
    return dict(zip(PLAN_FIELDS, out))


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
                           t_real: Optional[int] = None, return_lse: bool = False):
    """q (B, S, H, D); k, v (B, T, Hkv, D); one dtype (float32 or bfloat16),
    contiguous -> o (B, S, H, D) in that dtype.  Row i attends key j iff
    ``j < t_real`` (default T), ``j <= i`` when ``causal``, and ``j > i -
    window`` when ``window`` is set; a row with no such key gets the mean of
    v over the ``t_real`` rows.  With ``return_lse``: ``(o, lse)``, lse (B,
    H, S) fp32 each row's log-sum-exp of its scaled scores (not defined for
    a row with no key); o is bitwise the same either way."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, t_real=t_real,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel runs on cpu or cuda, not {q.device}")
    t_real = k.shape[1] if t_real is None else t_real
    _check(q, k, v, t_real, window)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse
           else None)
    if S == 0:
        return (o, lse) if return_lse else o
    path = route(q.dtype, D)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            ROUTES.index(path), _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
            B, S, T, H, Hkv, D, t_real, int(causal), window or 0, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel ({path}) launch failed for q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}: {msg} ({err})")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by_route[path] += 1
    return (o, lse) if return_lse else o


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention_backward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                                    causal: bool = True, window: Optional[int] = None):
    """The gradients ``(dq, dk, dv)`` of an aligned self-attention (S == T,
    every kv row real) from the forward's inputs, its output ``o`` and
    ``lse`` (``return_lse``) and the output gradient ``do`` (o's shape and
    dtype); each in its input's dtype.  Only the causal mask, with or
    without ``window``, has a backward: anything else raises."""
    if not causal:
        raise NotImplementedError("flash attention's backward takes only the causal mask "
                                  "(with or without a window)")
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError(f"flash attention's backward takes only an aligned "
                                  f"self-attention (S == T), got S={q.shape[1]}, "
                                  f"T={k.shape[1]}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    B, S, H, D = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 (B, H, S) = {(B, H, S)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward_kernel runs on cpu or cuda, not {q.device}")
    _check(q, k, v, k.shape[1], window)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {q.dtype} on {q.device}")
    if not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous on {q.device}")
    path = route(q.dtype, D)
    if path == "tensor_core" and do.data_ptr() % 16:
        raise ValueError("the tensor-core route copies do by 16 bytes: its data must be "
                         "16-byte aligned")
    Hkv = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_backward_launch(
            ROUTES.index(path), _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, Hkv, D, window or 0, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention backward ({path}) launch failed for q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}: {msg} ({err})")
    design = DESIGNS[lib.flash_attention_backward_kernel_of(_DTYPE_CODE[q.dtype], D)]
    flash_attention_backward_kernel.launches += 1
    flash_attention_backward_kernel.launches_by_route[path] += 1
    flash_attention_backward_kernel.launches_by_design[design] += 1
    return dq, dk, dv


flash_attention_backward_kernel.launches = 0
flash_attention_backward_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_backward_kernel.launches_by_design = dict.fromkeys(DESIGNS, 0)
