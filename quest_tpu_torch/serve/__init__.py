"""quest_tpu_torch.serve: the part of the serving layer the port has.

Only the metrics registry (`metrics`), which the durable executor
records into; the serving runtime itself (engine, fleet, IPC workers)
waits for ROADMAP A12.
"""
