"""Fault tolerance for long engine campaigns: inject, detect, recover (port
of ``repro.resilience``).

* :mod:`.faults` - deterministic, seeded fault injection at chunk
  boundaries (NaN, bit-flip SDC, host crash; on the Sharded plan a
  migration overflow and a corrupted halo face on one rank) through the
  engine's ``_fault_injector`` hook, on every plan.
* :mod:`.supervisor` - :class:`Supervisor` wraps ``Engine.run`` with
  rollback-retry: on a :class:`~repro_torch.telemetry.monitor.HealthError`
  it restores the newest checkpoint (carry and generators), pins it, backs
  off and retries; repeated same-class failures climb the degradation
  ladder (evict one slot through the engine's ``evict_slot_hook``, a
  larger cell capacity for an overflow, or a reduced-dt span, both through
  ``Engine.rebind``); :meth:`Supervisor.elastic_restore` moves a Sharded
  run onto another mesh.  Every action lands in the runlog as a
  structured event that :mod:`repro_torch.launch.report` renders.
"""
from repro_torch.resilience.faults import (Fault, FaultInjector, FaultPlan,
                                           install_faults)
from repro_torch.resilience.supervisor import Supervisor, SupervisorConfig

__all__ = ["Fault", "FaultPlan", "FaultInjector", "install_faults",
           "Supervisor", "SupervisorConfig"]
