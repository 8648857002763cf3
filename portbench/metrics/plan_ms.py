"""plan_ms: the host span, in set-up, around the call that builds the
job's program: the Circuit (or Trotter circuit) from the frozen inputs
and its fused plan with its operands on the card."""


def read(rec):
    return rec.plan_s * 1000.0
