"""Training and serving runtime (port of ``repro.runtime``)."""
from repro_torch.runtime import checkpoint  # noqa: F401
from repro_torch.runtime.faults import (  # noqa: F401
    FaultInjector,
    SimulatedPreemption,
    StragglerWatchdog,
)
from repro_torch.runtime.serve_loop import (  # noqa: F401
    BatchedServer, Request, RequestQueue, ServeStats)
from repro_torch.runtime.train_loop import (  # noqa: F401
    Trainer, TrainState, make_train_step)
