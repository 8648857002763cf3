"""quench: a Trotter quench of a ZZ / X Hamiltonian from |0...0>. A job
is init_zero_state, then evolution.run_evolution of the mix's
Hamiltonian (order, dt, steps, energy_every) through the configuration's
engine; the readout is the energies it records."""

from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench import counting, traffic, workloads
from portbench.reference import CONTROL, TRUTH
from portbench.reference import circuits as R


def pauli_codes(n: int, ham: dict):
    """(codes, coeffs) of a ZZ / X Hamiltonian in the port's Pauli-sum
    form (0 = I, 1 = X, 3 = Z), couplings first, as tfim_sum orders it."""
    rows, coeffs = [], []
    for a, b, j in ham["couplings"]:
        r = [0] * n
        r[a] = r[b] = 3
        rows.append(r)
        coeffs.append(j)
    for q, h in ham["fields"]:
        r = [0] * n
        r[q] = 1
        rows.append(r)
        coeffs.append(h)
    return np.asarray(rows), np.asarray(coeffs, dtype=np.float64)


class Job(workloads.Job):

    def __init__(self, config: dict, mix: dict, seed: int, device):
        super().__init__()
        self.n = int(config["qubits"])
        self.dtype = np.dtype(config["precision"])
        self.engine = workloads.engine(config)
        self.device = torch.device(device)
        self.ham = traffic.generate(self.n, mix, seed)
        self.codes, self.coeffs = pauli_codes(self.n, self.ham)
        self.dt, self.steps = float(mix["dt"]), int(mix["steps"])
        self.order, self.every = int(mix["order"]), int(mix["energy_every"])
        if self.order != 2 or self.steps % self.every:
            raise ValueError("the reference runs order-2 steps in whole "
                             "chunks of energy_every")
        self.work = counting.quench_work(self.ham, self.n, self.steps,
                                         self.steps // self.every + 1)

    def build(self) -> None:
        """The program: the Trotter circuit of one chunk and its plan
        (run_evolution finds both in their caches)."""
        from quest_tpu_torch import evolution as EV
        self.spec = EV.as_pauli_sum((self.codes, self.coeffs))
        circ = EV.trotter_circuit(self.spec, self.dt, order=self.order,
                                  steps=1)
        self.engine.build(circ, self.n, False, self.device, iters=self.every)

    def start(self) -> None:
        from quest_tpu_torch import state as ST
        self.q = ST.create_qureg(self.n, dtype=self.dtype, device=self.device)
        self.final = None

    def job(self, keep: bool = True) -> None:
        from quest_tpu_torch import evolution as EV
        from quest_tpu_torch import state as ST
        self.final = None
        with self.phase("reset"):
            self.q = ST.init_zero_state(self.q)
        with self.phase("evolve"):
            res = EV.run_evolution(self.spec, self.dt, self.steps,
                                   state=self.q, order=self.order,
                                   energy_every=self.every,
                                   engine=self.engine.evolution)
        self.final = res.state
        rec = {"energies": np.asarray(res.energies, np.float64).reshape(-1)}
        if keep:
            self.records.append(rec)

    def probes(self) -> dict:
        """energy_ms: CUDA events around calc_expec_pauli_sum of the
        Hamiltonian on the last job's state, the median of three."""
        if self.device.type != "cuda":
            return {}
        from quest_tpu_torch import calculations as K
        times = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            K.calc_expec_pauli_sum(self.final, self.codes, self.coeffs)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return {"energy_ms": statistics.median(times)}

    def output(self) -> dict:
        out = {"state": self.final.amps, "records": self.records}
        self.q = self.final = self.spec = self.records = None
        return out

    def _evolve(self, prec):
        psi = R.zero_state(self.n, prec, self.device)
        zz, xf = self.ham["couplings"], self.ham["fields"]
        energies = [R.zz_x_energy(psi, self.n, zz, xf)]
        for step in range(1, self.steps + 1):
            R.zz_x_strang_step(psi, self.n, zz, xf, self.dt, prec)
            if step % self.every == 0:
                energies.append(R.zz_x_energy(psi, self.n, zz, xf))
        return psi, np.asarray(energies)

    def control_output(self, jobs: int) -> dict:
        psi, energies = self._evolve(CONTROL)
        return {"state": psi, "records": [{"energies": energies}] * jobs}

    def compare(self, out: dict) -> dict:
        truth, energies = self._evolve(TRUTH)
        err = max(float(np.max(np.abs(r["energies"] - energies)
                               / np.abs(energies))) for r in out["records"])
        return {"state_err": workloads.rel_l2(out["state"], truth),
                "energy_err": err}
