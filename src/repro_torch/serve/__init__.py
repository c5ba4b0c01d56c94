from repro_torch.serve.adapt import ORDER_INDEX, OrderAdaptController
from repro_torch.serve.engine import (
    CONTINUOUS_FAMILIES,
    REQUEST_STATUSES,
    GenerationResult,
    Request,
    ServeEngine,
    StepStats,
    select_victim,
    supports_continuous,
)
from repro_torch.serve.faults import FAULT_SITES, Fault, FaultPlan, StepFault
from repro_torch.serve.kv_pool import (
    AdmissionError,
    PagedKVPool,
    PagePool,
    PoolError,
    PoolExhausted,
    assemble_cache_view,
)
from repro_torch.serve.scheduler import ContinuousScheduler, Slot, StepItem
from repro_torch.serve.spec import Drafter, ModelDrafter, NgramDrafter, make_drafter
from repro_torch.serve.tiering import HostPageStore, TieredPagePool, select_spill_victim

__all__ = [
    "ORDER_INDEX",
    "OrderAdaptController",
    "CONTINUOUS_FAMILIES",
    "REQUEST_STATUSES",
    "GenerationResult",
    "Request",
    "ServeEngine",
    "StepStats",
    "select_victim",
    "supports_continuous",
    "FAULT_SITES",
    "Fault",
    "FaultPlan",
    "StepFault",
    "AdmissionError",
    "PagedKVPool",
    "PagePool",
    "PoolError",
    "PoolExhausted",
    "assemble_cache_view",
    "ContinuousScheduler",
    "Slot",
    "StepItem",
    "Drafter",
    "ModelDrafter",
    "NgramDrafter",
    "make_drafter",
    "HostPageStore",
    "TieredPagePool",
    "select_spill_victim",
]
