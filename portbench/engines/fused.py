"""fused: the port's fused engine, Circuit.compiled_fused and
Circuit.apply_fused (the K1 segment kernel). `evolution` is the name
run_evolution takes for it."""

evolution = "fused"


def build(circuit, nbits: int, density: bool, device, iters: int = 1):
    """Plan the circuit and put its operands on the card."""
    circuit.compiled_fused(nbits, density, iters=iters, device=device)


def apply(circuit, q):
    return circuit.apply_fused(q)
