"""AVEC core: accelerator virtualization for cloud-edge (the paper's
contribution, as composable modules): the data plane (memory, wire,
transport), the destination executor and host runtimes, interception, the
profiler, the cost model, scheduling and migration."""
from repro_torch.core.virtualization import (  # noqa: F401
    AcceleratorSpec, AcceleratorRegistry, VirtualAccelerator,
    PAPER_TESTBED, JETSON_NANO, JETSON_TX2, CLOUD_RTX,
)
from repro_torch.core.cache import ModelCache, model_fingerprint  # noqa: F401
from repro_torch.core.memory import (  # noqa: F401
    BufferLease, BufferPool, PooledView, detach_tree, release_buffer,
)
from repro_torch.core.executor import (  # noqa: F401
    DestinationExecutor, HostRuntime, PipelinedHostRuntime, RemoteError,
)
from repro_torch.core.interception import (  # noqa: F401
    ArgExtractionError, ArgSpec, AvecSession, InterceptionLibrary,
)
from repro_torch.core.profiler import AvecProfiler  # noqa: F401
from repro_torch.core.costmodel import Workload  # noqa: F401
from repro_torch.core.scheduler import DeviceAwareScheduler, hedged_call  # noqa: F401
from repro_torch.core.migration import (  # noqa: F401
    HeartbeatMonitor, MigrationManager, SessionShadow,
)
