"""WikiKV core for the PyTorch port: the JAX-free host tier copied from
``repro.core`` (the Table II ``backends`` among it, their device backend
taking a torch device) plus the torch device tier (``tensorstore``,
``engine.DeviceEngine``).  The durable tier under both engines is
``repro_torch.storage``, copied from ``repro.storage``."""
from . import paths, records  # noqa: F401
from .store import DictKV, KVEngine, MemKV, PathStore  # noqa: F401
from .engine import (BatchPlanner, DeviceEngine, EngineStats,  # noqa: F401
                     HostEngine, QueryEngine, ShardedPathStore)
from .consistency import (CASConflict, ConsistentReader, Invalidation,  # noqa: F401
                          InvalidationBus, WikiWriter)
from .cache import TieredCache  # noqa: F401
from .schema import SchemaParams, schema_cost, structure_counts  # noqa: F401
from .oracle import HeuristicOracle, Oracle  # noqa: F401
from .coldstart import cold_start, ingestion_filter  # noqa: F401
from .evolution import AccessLog, CoAccessSketch, evolution_pass  # noqa: F401
from .errorbook import ErrorBook, run_errorbook  # noqa: F401
from .pipeline import ConstructionPipeline, PipelineConfig  # noqa: F401
from .navigate import (Navigator, NavResult, NavTrace, UnitBudget,  # noqa: F401
                       WallClockBudget, check_progressive)
