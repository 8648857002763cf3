"""Admission control for the serving engine: loud overflow, deadlines,
cancellation, and the tenancy policies (quota, priority shed).

A port of quest_tpu/serve/admission.py. Contracts
(tests/test_torch_serve.py holds each):

  * bounded queue — at most `QUEST_SERVE_MAX_QUEUE` requests may be
    pending across the engine's queues; the overflowing submit raises
    `RejectedError` at once in the caller, never a silent drop.
  * deadlines — a request whose relative `deadline_s` elapses while it
    is still queued fails with `DeadlineExceeded` before dispatch, so an
    expired request never occupies a launch. A request already
    dispatched when its deadline passes completes normally: a launch is
    never aborted.
  * cancellation — `Future.cancel()` succeeds exactly while the request
    is queued; the sweep drops it without charging a launch.
  * tenant quotas — `TenantQuota` bounds each tenant's pending requests
    (`QUEST_SERVE_TENANT_QUOTA`); the overflowing submit raises
    `TenantQuotaExceeded` naming the tenant and its quota.
  * priority shed — under pressure the lowest priority class sheds
    first, with `ShedError` naming the cause (the fleet that applies it
    is ROADMAP A12b; the typed errors live here).

Standard library only at import time except for the error base class,
which is the port's QuESTError.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from quest_tpu_torch.validation import QuESTError


class RejectedError(QuESTError):
    """The serving queue is full: the request was REJECTED at submit
    time (bounded queue depth, QUEST_SERVE_MAX_QUEUE). Callers should
    back off and resubmit; the engine never drops silently."""


class DeadlineExceeded(QuESTError):
    """The request's deadline elapsed before dispatch; it was failed
    without occupying a slot in any launch."""


class DispatchTimeout(QuESTError):
    """A serve launch exceeded the dispatch watchdog's deadline
    (QUEST_DISPATCH_TIMEOUT_S): the batch's futures fail with this, the
    program's breaker records the failure, and the supervisor REPLACES
    the wedged worker thread so the engine keeps serving instead of
    drain() hanging forever. The launch
    outcome is unknown — like a crash at dispatch, retrying could
    double-serve, so only durable requests requeue."""


class TenantQuotaExceeded(RejectedError):
    """The submitting tenant already has its quota's worth of pending
    requests in the fleet (QUEST_SERVE_TENANT_QUOTA): the request was
    rejected so one tenant's burst cannot occupy the whole bounded
    queue. A RejectedError subclass — generic backoff handling keeps
    working; the message names the tenant and quota."""


class ShedError(RejectedError):
    """The request was LOAD-SHED: fleet pressure (queue depth + open
    breakers) crossed QUEST_SERVE_SHED_THRESHOLD
    and this request sat in the lowest pending priority class. The
    message names the pressure cause. A RejectedError subclass —
    shedding is a rejection, just a prioritized one."""


# the quota every tenant gets when QUEST_SERVE_TENANT_QUOTA names no
# default= entry; the knob's registered default in env.py holds the same
# number (tests/test_torch_serve.py holds the two equal)
DEFAULT_TENANT_QUOTA = 256


def parse_tenant_quota(raw: str) -> Dict[str, int]:
    """Parse a QUEST_SERVE_TENANT_QUOTA spec (the knob's registered
    parser; raises ValueError on malformed input).

    Grammar: either one integer — the default per-tenant quota for
    every tenant — or a comma list of `tenant=quota` entries with an
    optional `default=` entry (absent: DEFAULT_TENANT_QUOTA, so a spec
    naming only specific tenants still yields a usable table):

        QUEST_SERVE_TENANT_QUOTA="64"
        QUEST_SERVE_TENANT_QUOTA="alice=16,bob=128,default=64"

    Returns {tenant_or_'default': quota}, always carrying 'default'.
    Named quotas may be 0 (that tenant is blocked outright); the
    default must be >= 1 (a fleet that admits nobody is a
    misconfiguration, not a policy)."""
    raw = raw.strip()
    out: Dict[str, int] = {}
    if "=" not in raw:
        out["default"] = _quota_int("default", raw)
        return out
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"QUEST_SERVE_TENANT_QUOTA entry {part!r} is not "
                f"tenant=quota (or a single default integer)")
        name, val = (s.strip() for s in part.split("=", 1))
        if not name:
            raise ValueError(
                f"QUEST_SERVE_TENANT_QUOTA entry {part!r} has an empty "
                f"tenant name")
        if name in out:
            raise ValueError(
                f"QUEST_SERVE_TENANT_QUOTA names tenant {name!r} twice")
        out[name] = _quota_int(name, val)
    if out.get("default", 1) < 1:
        raise ValueError(
            "QUEST_SERVE_TENANT_QUOTA default quota must be >= 1 (a "
            "fleet that admits nobody is a misconfiguration); block "
            "individual tenants with name=0 instead")
    out.setdefault("default", DEFAULT_TENANT_QUOTA)
    return out


def _quota_int(name: str, raw: str) -> int:
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"QUEST_SERVE_TENANT_QUOTA quota for {name!r} must be an "
            f"integer, got {raw!r}")
    if v < 0 or (name == "default" and v < 1):
        raise ValueError(
            f"QUEST_SERVE_TENANT_QUOTA quota for {name!r} must be "
            f">= {1 if name == 'default' else 0}, got {v}")
    return v


class TenantQuota:
    """Per-tenant pending-request bound (the fleet's admission layer).

    `table` is the parse_tenant_quota dict: named quotas win, the
    'default' entry covers everyone else. Like AdmissionController this
    class only DECIDES — the fleet holds the lock and the pending
    counts; `admit()` raises `TenantQuotaExceeded` when one more
    request would take `tenant` over its quota."""

    def __init__(self, table: Dict[str, int]):
        self.table = dict(table)
        self.table.setdefault("default", DEFAULT_TENANT_QUOTA)
        if self.table["default"] < 1:
            raise ValueError(
                f"tenant-quota default must be >= 1, got "
                f"{self.table['default']}")

    def quota_of(self, tenant: str) -> int:
        return self.table.get(tenant, self.table["default"])

    def admit(self, tenant: str, pending: int) -> None:
        quota = self.quota_of(tenant)
        if pending + 1 > quota:
            raise TenantQuotaExceeded(
                f"Invalid operation: tenant {tenant!r} already has "
                f"{pending} pending request(s) >= its quota {quota} "
                f"(QUEST_SERVE_TENANT_QUOTA); the request was rejected "
                f"so one tenant cannot occupy the whole queue — back "
                f"off and resubmit.")


class AdmissionController:
    """Queue-depth accounting and the pre-dispatch expiry/cancel sweep.

    The engine holds one controller; `admit()` runs under the engine
    lock on every submit, `sweep()` under the lock at every worker
    wake. The controller only DECIDES — completing the failed futures
    happens outside the lock (engine code), so user callbacks can never
    deadlock against submit."""

    def __init__(self, max_queue: int):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)

    def admit(self, pending: int) -> None:
        """Raise RejectedError when accepting one more request would
        exceed the bounded queue depth."""
        if pending + 1 > self.max_queue:
            raise RejectedError(
                f"Invalid operation: serve queue is full "
                f"({pending} pending >= QUEST_SERVE_MAX_QUEUE="
                f"{self.max_queue}); the request was rejected — back "
                f"off and resubmit.")

    @staticmethod
    def expiry_of(deadline_s: Optional[float],
                  now: Optional[float] = None) -> Optional[float]:
        """Absolute monotonic expiry for a relative deadline (None =
        no deadline). deadline_s <= 0 expires immediately — still
        through the normal sweep, so metrics count it as expired."""
        if deadline_s is None:
            return None
        if now is None:
            now = time.monotonic()
        return now + float(deadline_s)

    @staticmethod
    def sweep(requests, now: Optional[float] = None
              ) -> Tuple[List, List, List]:
        """Partition queued requests into (live, expired, cancelled).

        `requests` is any iterable of objects with `.expiry` (absolute
        monotonic or None) and `.future`. Cancelled futures are
        detected via Future.cancel()'s state; expiry wins over
        cancellation only in the sense that an expired-and-cancelled
        request counts as cancelled (the caller already walked away)."""
        if now is None:
            now = time.monotonic()
        live, expired, cancelled = [], [], []
        for r in requests:
            if r.future.cancelled():
                cancelled.append(r)
            elif r.expiry is not None and now >= r.expiry:
                expired.append(r)
            else:
                live.append(r)
        return live, expired, cancelled
