from .engine import generate, make_chunk_step, make_decode_step, make_prefill
from .fleet import PARK_META_PREFIX, FleetController, FleetRequest, FleetWorker, WorkerEvent
from .lifecycle import IllegalTransition, Slot, SlotState
from .sampling import greedy, temperature_sample
from .scheduler import CompletedRequest, DecodeScheduler, supports_continuous

__all__ = ["generate", "make_chunk_step", "make_decode_step", "make_prefill",
           "IllegalTransition", "Slot", "SlotState", "greedy",
           "temperature_sample", "CompletedRequest", "DecodeScheduler",
           "supports_continuous", "PARK_META_PREFIX", "FleetController",
           "FleetRequest", "FleetWorker", "WorkerEvent"]
