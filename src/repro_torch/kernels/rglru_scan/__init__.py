from .kernel import rglru_scan_backward_kernel, rglru_scan_kernel
from .ops import RGLRUScan, rglru_scan
from .ref import rglru_scan_backward_plain, rglru_scan_plain

__all__ = ["RGLRUScan", "rglru_scan", "rglru_scan_backward_kernel", "rglru_scan_backward_plain",
           "rglru_scan_kernel", "rglru_scan_plain"]
