"""quest_tpu_torch.serve: the continuous-batching execution service.

A port of quest_tpu/serve (ROADMAP A12a, A12b): `ServeEngine` coalesces
compatible requests from many clients into one batched launch per
program key (on the card, one batched sweep of the segment kernel per
segment) and adds admission, deadlines, supervision, poisoned-batch
isolation and a per-program breaker over the fused -> banded -> host
ladder (serve/engine.py); `serve.admission` holds the typed errors and
the queue policy; `serve.metrics` the standard-library counters,
histograms and Prometheus scrape; `serve.warmup` builds a declared
workload's programs up front. `ServeFleet` (serve/fleet.py) puts N
replicas behind one submit with routing, failover, tenant quotas and
priority shedding; a replica is a ServeEngine thread or a worker process
with its own CUDA context behind a `ReplicaProxy` (serve/ipc.py,
serve/worker_main.py); `Autoscaler` (serve/autoscaler.py) grows and
shrinks a fleet from its pressure.

`metrics`, `warmup` and `autoscaler` import only the standard library
at module level (tests/test_torch_isolation.py); everything else loads
on first access
through this namespace.
"""

from quest_tpu_torch.serve import metrics  # noqa: F401
# `warmup` the function shares its name with the submodule: import the
# submodule first, then bind the function over the package attribute
from quest_tpu_torch.serve.warmup import default_buckets, warmup  # noqa: F401,E402

_LAZY = {
    "ServeEngine": ("quest_tpu_torch.serve.engine", "ServeEngine"),
    "RejectedError": ("quest_tpu_torch.serve.admission", "RejectedError"),
    "DeadlineExceeded": ("quest_tpu_torch.serve.admission",
                         "DeadlineExceeded"),
    "ShedError": ("quest_tpu_torch.serve.admission", "ShedError"),
    "DispatchTimeout": ("quest_tpu_torch.serve.admission",
                        "DispatchTimeout"),
    "TenantQuota": ("quest_tpu_torch.serve.admission", "TenantQuota"),
    "TenantQuotaExceeded": ("quest_tpu_torch.serve.admission",
                            "TenantQuotaExceeded"),
    "AdmissionController": ("quest_tpu_torch.serve.admission",
                            "AdmissionController"),
    "ServeFleet": ("quest_tpu_torch.serve.fleet", "ServeFleet"),
    "ReplicaProxy": ("quest_tpu_torch.serve.ipc", "ReplicaProxy"),
    "Autoscaler": ("quest_tpu_torch.serve.autoscaler", "Autoscaler"),
}

__all__ = ["metrics", "default_buckets", "warmup"] + sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'quest_tpu_torch.serve' has no "
                             f"attribute {name!r}") from None
    import importlib
    mod = importlib.import_module(mod_name)
    for k, (m, a) in _LAZY.items():
        if m == mod_name:
            globals()[k] = getattr(mod, a)
    return globals()[name]
