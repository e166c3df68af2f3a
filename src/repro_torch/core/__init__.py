from repro_torch.core.channel import (  # noqa: F401
    AsyncQueue,
    Channel,
    ChannelClosed,
    DeviceLock,
    StalenessExceeded,
    VersionedItem,
)
from repro_torch.core.controller import Controller, ExecutionPlan  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    HeartbeatMonitor,
    InjectedFault,
)
from repro_torch.core.flowgraph import (  # noqa: F401
    FlowGraph,
    GraphTracer,
    TraceEvent,
    cycle_node_name,
)
from repro_torch.core.pipeline import (  # noqa: F401
    AsyncPipelineDriver,
    CycleSpec,
    ExecutionFlowManager,
    coalesce,
    merge_cycle_chunks,
    split_batch,
    stack_cycle_steps,
)
from repro_torch.core.placement import Cluster, PlacementManager, split_devices  # noqa: F401
from repro_torch.core.profiler import CostModel, Profiler, paper_like_profiles  # noqa: F401
from repro_torch.core.scheduler import (  # noqa: F401
    Async,
    Leaf,
    Pipelined,
    Scheduler,
    SchedulerConfig,
    Temporal,
    async_makespan,
    collocated_schedule,
    disaggregated_schedule,
)
from repro_torch.core.simulator import SimResult, Simulator  # noqa: F401
from repro_torch.core.switching import ContextSwitcher, SwitchRecord  # noqa: F401
from repro_torch.core.worker import FutureHandle, Worker, WorkerFailure, WorkerGroup  # noqa: F401
