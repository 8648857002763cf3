"""readout_ms: the device time a job of the traced window's readout
spans (`readout.sample`, `readout.linear_xeb`, `readout.total_prob`,
`readout.purity`; one inside another counts once): their summed device
ms over the jobs of the window."""

from portbench import spans

PREFIX = "readout."


def read(rec):
    found = [s for s in spans.records(rec) or ()
             if s["name"].startswith(PREFIX)
             and not (s["parent"] or "").startswith(PREFIX)
             and s["device_ms"] is not None]
    if not found or not rec.jobs:
        return None
    return sum(s["device_ms"] for s in found) / rec.jobs
