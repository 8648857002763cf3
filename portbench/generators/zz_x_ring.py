"""zz_x_ring: tfim_sum(n) of quest_tpu_torch. ZZ couplings on the ring
(i, i + 1 mod n) and X fields on every qubit, each coefficient the mix's
value times (1 + disorder * u), u uniform in [-1, 1) from the run's
seed."""

from portbench.traffic import stream


def generate(n: int, mix: dict, seed: int) -> dict:
    rng = stream(seed, "coefficients")
    jitter = 1.0 + mix["disorder"] * rng.uniform(-1.0, 1.0, size=2 * n)
    return {"couplings": [(i, (i + 1) % n, mix["coupling"] * float(jitter[i]))
                          for i in range(n)],
            "fields": [(q, mix["field"] * float(jitter[n + q]))
                       for q in range(n)]}
