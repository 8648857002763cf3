"""quench.energy_device_ms: the mean device time of the traced window's
`expec.value` spans (CUDA events on the stream at the span's ends): one
grouped energy of ops/expec.py as the timed jobs run it."""

from portbench import spans


def read(rec):
    return spans.mean_device_ms(rec, "expec.value")
