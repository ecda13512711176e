"""Pauli-frame sampling (`sim.frame`) and batched stabilizer tableaus
(`sim.tableau`, bit-packed `sim.tableau_packed` with the fused measurement
kernel in `sim.cuda_measure`) under seeded Pauli noise (`sim.noise`).
`sim.statevec` is the dense statevector oracle of the tableau tests."""

from qcss_tpu_torch.sim import frame, noise, tableau, tableau_packed
from qcss_tpu_torch.sim.tableau import Tableau, measure_z, reset_z, run_circuit

__all__ = ["Tableau", "frame", "measure_z", "noise", "reset_z", "run_circuit",
           "tableau", "tableau_packed"]
