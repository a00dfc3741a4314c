"""The simulated cloud and the FaaSKeeper pieces the serving path needs:
:class:`SimCloud`, the FIFO dispatch queue, the function runtime and the
KV page-blob store."""

from .functions import LAMBDA_GBS_PRICE, LAMBDA_INVOKE_PRICE, FunctionRuntime
from .queues import FifoQueue
from .simcloud import FaultPlan, SimCloud, SimulatedCrash, Sleep, Wait
from .storage import PageBlobStore

__all__ = ["FaultPlan", "FifoQueue", "FunctionRuntime", "LAMBDA_GBS_PRICE",
           "LAMBDA_INVOKE_PRICE", "PageBlobStore", "SimCloud", "SimulatedCrash", "Sleep",
           "Wait"]
