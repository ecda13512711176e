"""Matching graphs and device union-find decoders: the circuit-level DEM
(`dem`), the dense stencil decoder (`device_uf`) and the defect-granular
sparse decoder (`device_sparse`)."""

from qcss_tpu_torch.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu_torch.decode.device_sparse import (
    make_hybrid_obs_decoder,
    make_sparse_obs_decoder,
)
from qcss_tpu_torch.decode.device_uf import make_obs_decoder
from qcss_tpu_torch.decode.spacetime import detector_history
from qcss_tpu_torch.decode.uf import (
    MatchingGraph,
    graph_from_checks,
    spacetime_graph,
)

__all__ = [
    "MatchingGraph",
    "circuit_level_graph",
    "detector_history",
    "extraction_gate_list",
    "graph_from_checks",
    "make_hybrid_obs_decoder",
    "make_obs_decoder",
    "make_sparse_obs_decoder",
    "spacetime_graph",
]
