"""quench.energy_idle: the share of the traced window in which no device
operation ran while the innermost open program span on the job's thread
was `expec.value` (the grouped energies of ops/expec.py): each idle gap
of the device trace attributed by its midpoint (portbench/spans.py)."""

from portbench import spans

SPAN = "expec.value"


def read(rec):
    if not spans.records(rec, {SPAN}):
        return None
    idle = spans.idle_by_span(rec)
    return 100.0 * idle.get(SPAN, [0.0])[0] / rec.trace.window_s
