"""build_ms: the host seconds x 1000 the process spent building
programs, from the program's always-on span totals: `plan.fused` (a
fused program's plan and operand upload), `plan.trotter` (a Trotter
plan or step circuit) and `plan.expec` (a grouped expectation plan),
each a cache miss. Their child spans (plan.fusion, plan.sweep,
plan.upload) lie inside plan.fused and are not added again. Every
build of the process counts, the warm job's lazy plans too."""

from portbench import spans

BUILDS = ("plan.fused", "plan.trotter", "plan.expec")


def read(rec):
    totals = spans.totals()
    found = [totals[k]["seconds"] for k in BUILDS if k in (totals or {})]
    return 1000.0 * sum(found) if found else None
