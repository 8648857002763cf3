"""quest_tpu_torch.resilience: fault injection and durable execution.

A port of quest_tpu/resilience (ROADMAP A11):

  * `faults`: deterministic fault injection at named sites (`FaultPlan`,
    the `QUEST_FAULT_PLAN` knob); zero-cost when empty. Standard library
    only.
  * `supervisor`: the bounded-restart backoff policy of the serving
    worker. Standard library only.
  * `breaker`: the per-program circuit breaker that drives the serving
    engine's fused -> banded -> host ladder. Standard library only.
  * `durable`: mid-circuit checkpointing, preemption-tolerant resume and
    corruption sentinels (`run_durable`, `run_durable_trajectories`).
    It imports torch and the engines, so it loads lazily through this
    namespace and the package import stays standard-library only.
"""

from quest_tpu_torch.resilience import faults  # noqa: F401
from quest_tpu_torch.resilience.breaker import Breaker  # noqa: F401
from quest_tpu_torch.resilience.faults import FaultPlan, InjectedFault  # noqa: F401
from quest_tpu_torch.resilience.supervisor import Supervisor  # noqa: F401

_LAZY = {
    "durable": ("quest_tpu_torch.resilience.durable", None),
    "run_durable": ("quest_tpu_torch.resilience.durable", "run_durable"),
    "run_durable_trajectories": ("quest_tpu_torch.resilience.durable",
                                 "run_durable_trajectories"),
    "DurableError": ("quest_tpu_torch.resilience.durable", "DurableError"),
    "IntegrityError": ("quest_tpu_torch.resilience.durable",
                       "IntegrityError"),
}

__all__ = ["faults", "FaultPlan", "InjectedFault", "Breaker",
           "Supervisor"] + sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'quest_tpu_torch.resilience' has no "
                             f"attribute {name!r}") from None
    import importlib
    mod = importlib.import_module(mod_name)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value
