"""circuit: a gate list on a statevector or density register. A job is
init_zero_state on the register, the configuration's engine applied to
the mix's gate list, then the readout: `samples` shots drawn by
measurement.sample and calc_linear_xeb of them, or (a density register)
calc_total_prob and calc_purity."""

from __future__ import annotations

import numpy as np
import torch

from portbench import counting, traffic, workloads
from portbench.reference import CONTROL, TRUTH
from portbench.reference import circuits as R


class Job(workloads.Job):

    def __init__(self, config: dict, mix: dict, seed: int, device):
        super().__init__()
        self.n = int(config["qubits"])
        self.dtype = np.dtype(config["precision"])
        self.density = config["register"] == "density"
        self.nbits = 2 * self.n if self.density else self.n
        self.engine = workloads.engine(config)
        self.device = torch.device(device)
        self.seed = seed
        self.gates = traffic.generate(self.n, mix, seed)
        self.shots = int(mix.get("samples", 0))
        self.work = counting.circuit_work(self.gates, self.nbits, self.density,
                                          reads=1)

    def _sampler(self) -> torch.Generator:
        seed = int(traffic.stream(self.seed, "samples").integers(1 << 62))
        return torch.Generator().manual_seed(seed)

    def build(self) -> None:
        """The program: the circuit and its plan, built once."""
        from quest_tpu_torch.circuit import Circuit
        c = Circuit(self.n)
        for g in self.gates:
            getattr(c, g[0])(*g[1:])
        self.engine.build(c, self.nbits, self.density, self.device)
        self.circuit = c

    def start(self) -> None:
        from quest_tpu_torch import state as ST
        make = ST.create_density_qureg if self.density else ST.create_qureg
        self.q = make(self.n, dtype=self.dtype, device=self.device)
        self.gen = self._sampler()

    def job(self, keep: bool = True) -> None:
        from quest_tpu_torch import calculations as K
        from quest_tpu_torch import measurement as MS
        from quest_tpu_torch import state as ST
        with self.phase("reset"):
            q = ST.init_zero_state(self.q)
        with self.phase("apply"):
            self.q = q = self.engine.apply(self.circuit, q)
        with self.phase("readout"):
            if self.shots:
                gs = self.gen.get_state()
                s = MS.sample(q, self.shots, self.gen)
                rec = {"xeb": K.calc_linear_xeb(q, s), "samples": s,
                       "gen_state": gs}
            else:
                rec = {"total_prob": K.calc_total_prob(q),
                       "purity": K.calc_purity(q)}
        if keep:
            self.records.append(rec)

    def output(self) -> dict:
        """What the timed path produced, the program dropped: the last
        job's planes and every job's readout."""
        out = {"state": self.q.amps, "records": self.records}
        self.circuit = self.q = self.records = None
        return out

    def reference(self, prec) -> torch.Tensor:
        psi = R.zero_state(self.nbits, prec, self.device)
        run = R.run_density if self.density else R.run_statevector
        return run(psi, self.n, self.gates, prec)

    def _uniforms(self, gen_state) -> torch.Tensor:
        g = torch.Generator()
        g.set_state(gen_state)
        return torch.rand(self.shots, generator=g, dtype=torch.float32)

    def control_output(self, jobs: int) -> dict:
        psi = self.reference(CONTROL)
        records = []
        if self.shots:
            gen, cdf = self._sampler(), R.probabilities_cdf(psi)
            for _ in range(jobs):
                gs = gen.get_state()
                u = torch.rand(self.shots, generator=gen, dtype=torch.float32)
                s = R.sample(cdf, u)
                records.append({"xeb": R.linear_xeb(psi, s), "samples": s,
                                "gen_state": gs})
            del cdf
        else:
            rec = {"total_prob": R.density_trace(psi, self.n),
                   "purity": R.density_purity(psi)}
            records = [rec] * jobs
        return {"state": psi, "records": records}

    def compare(self, out: dict) -> dict:
        truth = self.reference(TRUTH)
        nums = {"state_err": workloads.rel_l2(out["state"], truth)}
        recs = out["records"]
        if self.shots:
            cdf = R.probabilities_cdf(truth)
            nums["xeb_err"] = max(abs(r["xeb"] - R.linear_xeb(truth, r["samples"]))
                                  for r in recs)
            nums["sample_gap"] = max(
                R.sample_gap(cdf, r["samples"], self._uniforms(r["gen_state"]))
                for r in recs)
        else:
            tr, pur = R.density_trace(truth, self.n), R.density_purity(truth)
            nums["trace_err"] = max(abs(r["total_prob"] - tr) for r in recs)
            nums["purity_err"] = max(abs(r["purity"] - pur) / pur for r in recs)
        return nums
