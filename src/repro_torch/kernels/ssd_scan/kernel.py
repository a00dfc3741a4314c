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
the launches it holds, ``serve/graphs.py``),
``ssd_scan_kernel.launches_by_route`` counts them per route, and
``ssd_scan_kernel.launches_by_kind`` per length: ``"decode"`` (L = 1, on
the tensor-core route the streaming ``ssd_decode_kernel``) and ``"chunk"``
(L >= 2).

The backward (:func:`ssd_scan_backward_kernel`, one call of the library's
``ssd_scan_backward_launch``: three launches, the state passes, the chunk
kernel and a reduction) gives (dx, ddt, dA, dBm, dCm, dh0)
deterministically (no floating-point atomics), on the forward's two
routes by the forward's rule (the library's ``ssd_scan_backward_route``):

* ``"tensor_core"`` (bf16, P a multiple of 16, N 64/128/256; mamba2-1.3b's
  training): mma.sync with bf16 operands, the fp32 ones as hi + lo pairs;
  the state passes walk the chunks with the state in registers, the chunk
  kernel runs one block per (chunk, batch row) over the heads in order and
  forms C.B^T, dC's and dB's intra-chunk products once per chunk from the
  sum of dG over heads (no per-head partials).  Its plan (grid, chunk,
  head order, shared memory) is :func:`library_plan`, modelled by
  ``plan.py``;
* ``"cuda_core"``: fp32 arithmetic for float32 and bf16 at other dims, with
  per-head partials of dB and dC summed in head order by the third launch.

Its chunk length is the library's (``ssd_scan_backward_chunk``), which
sizes the scratch the wrapper allocates.  ``ssd_scan_backward_kernel.launches``
counts its calls that reach the card, ``.launches_by_route`` per route.
A direct call of the forward with an input that requires grad still
raises (:func:`~repro_torch.kernels.grad_guard.refuse_grad`): the model
path reaches both through ``ops.SSDScan``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..grad_guard import refuse_grad
from .ref import ssd_scan_backward_plain, ssd_scan_plain

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
        lib.ssd_scan_backward_launch.argtypes = [i] + [p] * 19 + [i, i, i, i, i, p]
        lib.ssd_scan_backward_launch.restype = i
        lib.ssd_scan_backward_chunk.argtypes = [i, i, i, i]
        lib.ssd_scan_backward_chunk.restype = i
        lib.ssd_scan_backward_plan.argtypes = [i, i, i, i, i, p]
        lib.ssd_scan_backward_plan.restype = i
        lib.ssd_scan_backward_route.argtypes = [i, i, i]
        lib.ssd_scan_backward_route.restype = i
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
    refuse_grad("ssd_scan_kernel (the SSD scan)", "1.7.1", x, dt, A, Bm, Cm, h0,
                via="ops.SSDScan (ops.ssd_scan)")
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
    ssd_scan_kernel.launches_by_kind["decode" if L == 1 else "chunk"] += 1
    return y, h_final


ssd_scan_kernel.launches = 0
ssd_scan_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
ssd_scan_kernel.launches_by_kind = dict.fromkeys(("chunk", "decode"), 0)


def backward_route(dtype: torch.dtype, P: int, N: int) -> str:
    """The route of the backward for this dtype, P and N, as the built
    library's ``ssd_scan_backward_route`` gives it: the forward's rule
    (``"tensor_core"`` for bf16 at P a multiple of 16 and N 64, 128 or
    256, ``"cuda_core"`` otherwise).  Needs the library."""
    return ROUTES[_library().ssd_scan_backward_route(_DTYPE_CODE[dtype], P, N)]


def backward_chunk(dtype: torch.dtype, L: int, P: int, N: int) -> int:
    """The backward's chunk length for these dims on its route, as the
    library's ``ssd_scan_backward_chunk`` gives it (0 where no chunk fits
    shared memory)."""
    return _library().ssd_scan_backward_chunk(_DTYPE_CODE[dtype], L, P, N)


def library_plan(B: int, L: int, H: int, P: int, N: int) -> dict:
    """The tensor-core backward's plan at these dims, as the built library
    exports it (``ssd_scan_backward_plan``), keyed as ``plan.Plan``."""
    out = (ctypes.c_int * 14)()
    err = _library().ssd_scan_backward_plan(B, L, H, P, N, out)
    if err != 0:
        raise ValueError(f"the tensor-core backward does not take P={P}, N={N}")
    v = list(out)
    return {"chunk": v[0], "p_slab": v[1], "pass_rows": v[2], "chunk_grid": tuple(v[3:6]),
            "chunk_threads": v[6], "chunk_smem": v[7], "pass_grid": tuple(v[8:11]),
            "pass_threads": v[11], "pass_smem": v[12],
            "head_order": "ascending" if v[13] == 0 else f"code {v[13]}"}


def _check_backward(x, N: int, dy, dh_final) -> None:
    Bsz, L, H, P = x.shape
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if dh_final is not None and (tuple(dh_final.shape) != (Bsz, H, P, N)
                                 or dh_final.dtype != torch.float32
                                 or dh_final.device != x.device):
        raise ValueError(f"dh_final must be ({Bsz}, {H}, {P}, {N}) float32 on {x.device}, "
                         f"got {tuple(dh_final.shape)} {dh_final.dtype} on {dh_final.device}")
    for name, t in (("dy", dy), ("dh_final", dh_final)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_scan_backward_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                             Bm: torch.Tensor, Cm: torch.Tensor, h0: Optional[torch.Tensor],
                             dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None, *,
                             chunk: int = 256):
    """The gradients of :func:`ssd_scan_kernel`'s ``(y, h_final)`` given
    ``dy`` (B, L, H, P) in x's dtype and ``dh_final`` (B, H, P, N) float32
    or None (no gradient on the final state), the inputs as there ->
    ``(dx, ddt, dA, dBm, dCm, dh0)``, each in its input's dtype, dh0 None
    when h0 is None.  ``chunk`` is the plain version's (CPU tensors); the
    kernel takes its own (``ssd_scan_backward_chunk``: up to 64 tokens),
    which changes only the rounding (:func:`.ref.bf16_backward_rounding_bound`
    with the route's ``kernel_route`` and chunk)."""
    if x.device.type == "cpu":
        return ssd_scan_backward_plain(x, dt, A, Bm, Cm, h0, dy, dh_final, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_backward_kernel runs on cpu or cuda, not {x.device}")
    _check(x, dt, A, Bm, Cm, h0)
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    _check_backward(x, N, dy, dh_final)
    tensors = (x, Bm, Cm, dy) + tuple(t for t in (h0, dh_final) if t is not None)
    if any(t.data_ptr() % 16 for t in tensors if t.numel()):
        raise ValueError("ssd_scan_backward_kernel takes x, Bm, Cm, h0, dy and dh_final "
                         "16-byte aligned, as the forward's tensor-core route does")
    dx, ddt, dA = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if x.numel() == 0 or N == 0:
        for t in (dx, ddt, dA, dB, dC):
            t.zero_()
        if dh0 is not None and dh_final is not None:
            dh0.copy_(dh_final)
        elif dh0 is not None:
            dh0.zero_()
        return dx, ddt, dA, dB, dC, dh0
    lib = _library()
    Q = lib.ssd_scan_backward_chunk(_DTYPE_CODE[x.dtype], L, P, N)
    if Q == 0:
        raise ValueError(f"ssd_scan_backward_kernel: a chunk of P={P}, N={N} does not fit "
                         "shared memory (the backward holds a chunk's B, C, x, dy and the "
                         "P x N adjoint of the state in it)")
    nc = -(-L // Q)
    f32 = dict(dtype=torch.float32, device=x.device)
    hs = torch.empty((Bsz, nc, H, P, N), **f32)
    dhs = torch.empty((Bsz, nc, H, P, N), **f32)
    pA = torch.empty((Bsz, nc, H), **f32)
    path = backward_route(x.dtype, P, N)
    # per-head partials of dB and dC: the CUDA-core route's alone (the
    # tensor-core route sums over heads inside its chunk kernel)
    pB = pC = None
    if path == "cuda_core":
        pB = torch.empty((Bsz, L, H, N), **f32)
        pC = torch.empty((Bsz, L, H, N), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()        # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_backward_launch(
            _DTYPE_CODE[x.dtype], *(ptr(t) for t in (
                x, dt, A, Bm, Cm, h0, dy, dh_final, dx, ddt, dA, dB, dC, dh0, hs, dhs, pA, pB,
                pC)), Bsz, L, H, P, N, stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan backward launch failed for x {tuple(x.shape)}, N={N}: "
                           f"{msg} ({err})")
    ssd_scan_backward_kernel.launches += 1
    ssd_scan_backward_kernel.launches_by_route[path] += 1
    return dx, ddt, dA, dB, dC, dh0


ssd_scan_backward_kernel.launches = 0
ssd_scan_backward_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
