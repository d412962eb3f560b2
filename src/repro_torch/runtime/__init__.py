from repro_torch.runtime.elastic import plan_elastic_mesh  # noqa: F401
from repro_torch.runtime.faultinject import (NaNInjector,  # noqa: F401
                                             ScriptedPreemption,
                                             SimulatedKill, torn_save)
from repro_torch.runtime.heartbeat import HeartbeatMonitor  # noqa: F401
from repro_torch.runtime.preemption import PreemptionHandler  # noqa: F401
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
