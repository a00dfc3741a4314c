"""The simulated cloud and the FaaSKeeper pieces the serving path needs:
:class:`SimCloud`, the FIFO dispatch queue and the function runtime."""

from .functions import LAMBDA_GBS_PRICE, LAMBDA_INVOKE_PRICE, FunctionRuntime
from .queues import FifoQueue
from .simcloud import FaultPlan, SimCloud, SimulatedCrash, Sleep, Wait

__all__ = ["FaultPlan", "FifoQueue", "FunctionRuntime", "LAMBDA_GBS_PRICE",
           "LAMBDA_INVOKE_PRICE", "SimCloud", "SimulatedCrash", "Sleep", "Wait"]
