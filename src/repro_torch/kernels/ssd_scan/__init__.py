from . import plan
from .kernel import ssd_scan_backward_kernel, ssd_scan_kernel
from .ops import SSDScan, ssd_scan, ssd_scan_shard
from .ref import (bf16_backward_rounding_bound, dropped_chunk_effects, ssd_scan_backward_plain,
                  ssd_scan_backward_split_emulation, ssd_scan_plain)

__all__ = ["SSDScan", "bf16_backward_rounding_bound", "dropped_chunk_effects", "plan", "ssd_scan",
           "ssd_scan_backward_kernel", "ssd_scan_backward_plain",
           "ssd_scan_backward_split_emulation", "ssd_scan_kernel", "ssd_scan_plain",
           "ssd_scan_shard"]
