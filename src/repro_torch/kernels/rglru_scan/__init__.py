from .kernel import rglru_scan_kernel
from .ops import rglru_scan
from .ref import rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_kernel", "rglru_scan_plain"]
