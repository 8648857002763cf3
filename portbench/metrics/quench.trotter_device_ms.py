"""quench.trotter_device_ms: the mean device time of the traced window's
`evolution.chunk` spans (CUDA events on the stream at the span's ends):
one chunk of Trotter steps of run_evolution, its fused program's K1
launches."""

from portbench import spans


def read(rec):
    return spans.mean_device_ms(rec, "evolution.chunk")
