"""Where the paged-attention kernel looks: the split plan and the live pages.

Plain Python, shared by the wrapper (which launches ``split_count(...)``
splits per slot and kv head), the plain split-and-merge version in
``ref.py``, and the tests.  The CUDA kernel computes :func:`live_pages` and
:func:`split_pages` on the device with the same integer arithmetic, since
the lengths live there.

Lane ``t`` of logical page ``j`` sits at position ``j * pos_stride +
lane_base + t``; it is attended iff its page is mapped, the position is
below the slot's length and, with a window, above ``q_pos - window``.
"""

from __future__ import annotations

from typing import Optional, Tuple

H100_SMS = 132
MIN_PAGES_PER_SPLIT = 4
MAX_SPLITS = 64


def split_count(B: int, Hkv: int, max_pages: int, n_sms: int = H100_SMS) -> int:
    """Page splits per (slot, kv head), from the shapes alone (the lengths
    are on the device; reading them would sync the host every layer).  One
    split once ``B * Hkv`` blocks fill the SMs; below that, enough splits
    for about two blocks per SM, with at least ``MIN_PAGES_PER_SPLIT`` of
    the table's pages per split and at most ``MAX_SPLITS``."""
    rows = B * Hkv
    if rows >= n_sms:
        return 1
    return max(1, min(-(-2 * n_sms // rows), -(-max_pages // MIN_PAGES_PER_SPLIT), MAX_SPLITS))


def window_first_page(q_pos: int, window: int, lane_base: int, pos_stride: int,
                      page_size: int) -> int:
    """The first logical page holding a lane inside the window (position
    ``>= q_pos - window + 1``); page ``j``'s last lane sits at ``j *
    pos_stride + lane_base + page_size - 1``."""
    num = q_pos - window + 2 - lane_base - page_size
    return 0 if num <= 0 else -(-num // pos_stride)


def live_pages(length: int, q_pos: int, window: Optional[int], lane_base: int,
               pos_stride: int, page_size: int, max_pages: int) -> Tuple[int, int]:
    """``(lo, hi)``: every live lane of the slot lies on a page in ``[lo,
    hi)``; ``hi`` is one past the last page holding a position below
    ``length``, ``lo`` the window's first page (0 without a window)."""
    hi = min(-(-(length - lane_base) // pos_stride), max_pages) if length > lane_base else 0
    lo = 0 if window is None else min(window_first_page(q_pos, window, lane_base, pos_stride,
                                                        page_size), hi)
    return lo, hi


def split_pages(lo: int, hi: int, n_split: int, split: int) -> Tuple[int, int]:
    """Split ``split``'s share of the pages ``[lo, hi)``: equal runs of
    ``ceil((hi - lo) / n_split)`` pages, the last ones possibly empty."""
    chunk = -(-(hi - lo) // n_split)
    a = min(hi, lo + split * chunk)
    return a, min(hi, a + chunk)
