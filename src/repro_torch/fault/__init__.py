"""Fault tolerance for federated rounds: deterministic fault schedules
(``plan.py``) consumed by ``core/server.FederatedZO`` and the
checkpoint/resume path (``checkpoint/state.py``)."""
from repro_torch.fault.plan import NO_FAULTS, FaultPlan, RoundFaults, kill_now

__all__ = ["FaultPlan", "RoundFaults", "NO_FAULTS", "kill_now"]
