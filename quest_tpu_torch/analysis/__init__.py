"""Static analysis and runtime audits of the PyTorch/CUDA port.

quest-lint (`quest_tpu_torch.analysis.lint`) checks the invariants that
do not depend on JAX: program-cache key completeness (QL001), loud knob
parsing (QL004), _GUARDED_BY lock discipline (QL005), no blocking call
under a lock (QL007), atomic persistence writes (QL008) and fault-site
catalog integrity (QL009). The audit harness
(`quest_tpu_torch.analysis.audit`) checks the dynamic halves: a second
pass over a golden circuit set builds nothing, a flipped keyed knob
misses every program cache, and the lock acquisition order is acyclic.

CLI: ``python -m quest_tpu_torch.analysis [paths ...]`` (default: the
port's package, its tests tests/test_torch_*.py,
scripts/profile_torch_submit.py and chip_smoke.py; exits 1 on any
violation).
"""

from quest_tpu_torch.analysis.lint import (  # noqa: F401
    JAX_RULES, RULES, Violation, run_lint)
