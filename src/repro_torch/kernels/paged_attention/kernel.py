"""Paged-attention decode (S=1): the hand-written CUDA kernel's wrapper.

The kernel (``kernels/csrc/paged_attention.cu``) streams each slot's K/V
pages straight out of the shared ``(n_pages, page_size, Hkv, D)`` pool
through the slot's page-table row, so the gathered ``(B, T, Hkv, D)`` cache
never exists in device memory.  It returns the **unnormalized** fp32
online-softmax state ``(acc, m, l)``; ``ops.py`` splices in the new token and
normalizes.  When ``B x Hkv`` blocks would leave the SMs idle, the launch
splits each slot's live pages ``plan.split_count(...)`` ways and merges the
splits' states inside the same launch; the scratch it merges through is
allocated once per device, stream and shape and cached here, so launches
on two streams never share partials or tickets.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (:func:`.ref.paged_attention_plain`), CUDA tensors launch
the kernel or raise.  ``paged_attention_kernel.launches`` counts kernel
launches (never plain-version calls; a CUDA graph's replay adds the
launches it holds, ``serve/graphs.py``);
``paged_attention_kernel.last_splits`` holds the split count of the last
launch or capture.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..grad_guard import refuse_grad
from .plan import split_count
from .ref import paged_attention_plain

_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_sms: dict = {}          # device index -> SM count
_scratch: dict = {}      # (device index, stream, B, Hkv, G, D, n_split) -> (partials, tickets)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..build import load

        lib = load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            i, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p, p]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_partial_floats.argtypes = [i, i]
        lib.paged_attention_partial_floats.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _split_plan(lib, dev: torch.device, stream: int, B: int, Hkv: int, G: int, D: int,
                max_pages: int):
    """``(n_split, partials pointer, tickets pointer)`` for a launch on
    ``stream``; the scratch of a split launch is allocated once per device,
    stream and shape (the tickets zeroed; the kernel leaves them zero, so
    every replay of a captured launch finds them zero).  Launches on one
    stream run in order, so they may share it.  A capture must find the
    scratch already there (the warm-up of ``serve/graphs.py`` allocates it
    on the capture stream)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    n_split = split_count(B, Hkv, max_pages, _sms[idx])
    if n_split == 1:
        return 1, None, None
    key = (idx, stream, B, Hkv, G, D, n_split)
    if key not in _scratch:
        if torch.cuda.is_current_stream_capturing():
            # allocated here it would live in the graph's pool, zeroed by the graph
            raise RuntimeError("paged_attention: no split scratch for this stream and shape "
                               "yet; run the launch once on the capture stream before "
                               "capturing it")
        floats = B * Hkv * n_split * lib.paged_attention_partial_floats(G, D)
        _scratch[key] = (torch.empty(floats, dtype=torch.float32, device=dev),
                         torch.zeros(B * Hkv, dtype=torch.int32, device=dev))
    part, tickets = _scratch[key]
    return n_split, part.data_ptr(), tickets.data_ptr()


def paged_attention_kernel(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           q_pos: torch.Tensor, *, lane_base: int = 0,
                           pos_stride: Optional[int] = None,
                           window: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: (B, Hkv, G, D); kp/vp: (n_pages, page_size, Hkv, D);
    page_table: (B, max_pages) int32, -1 = unmapped; lengths/q_pos: (B,)
    int32.

    Returns ``(acc, m, l)`` — acc ``(B, Hkv, G, D)`` fp32 unnormalized, m/l
    ``(B, Hkv, G)`` fp32.  Rows with no live lane come out as
    ``(0, -1e30, 0)``.  ``lane_base``/``pos_stride`` place lane ``t`` of
    page ``j`` at position ``j * pos_stride + lane_base + t`` (defaults: 0
    and the page size).
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, kp, vp, page_table, lengths, q_pos,
                                     lane_base=lane_base, pos_stride=pos_stride,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_kernel runs on cpu or cuda, not {q.device}")
    refuse_grad("paged_attention_kernel (decode attention, serving only)", "1.7", q, kp, vp)
    B, Hkv, G, D = q.shape
    n_pages, page_size = kp.shape[0], kp.shape[1]
    max_pages = page_table.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's y limit 65535")
    pos_stride = page_size if pos_stride is None else int(pos_stride)
    if pos_stride < 1:
        raise ValueError(f"pos_stride must be >= 1, got {pos_stride}")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("kp and vp are copied by 16 bytes: their data must be 16-byte aligned")
    dev = q.device
    _check("q", q, q.dtype, (B, Hkv, G, D), dev)
    _check("kp", kp, q.dtype, (n_pages, page_size, Hkv, D), dev)
    _check("vp", vp, q.dtype, (n_pages, page_size, Hkv, D), dev)
    _check("page_table", page_table, torch.int32, (B, max_pages), dev)
    _check("lengths", lengths, torch.int32, (B,), dev)
    _check("q_pos", q_pos, torch.int32, (B,), dev)
    acc = torch.empty((B, Hkv, G, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    if B == 0 or Hkv == 0 or G == 0:
        return acc, m, l
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        n_split, part, tickets = _split_plan(lib, dev, stream, B, Hkv, G, D, max_pages)
        err = lib.paged_attention_launch(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), q_pos.data_ptr(),
            int(lane_base), pos_stride, int(window is not None),
            int(window or 0), B, Hkv, G, page_size, max_pages, n_split,
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), part, tickets, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed ({n_split} splits): "
                           f"{msg} ({err})")
    paged_attention_kernel.launches += 1
    paged_attention_kernel.last_splits = n_split
    return acc, m, l


paged_attention_kernel.launches = 0
paged_attention_kernel.last_splits = None
