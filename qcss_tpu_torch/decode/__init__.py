"""Decoders of the port: syndrome-table decoding (`lut`), the code-capacity
Monte Carlo (`montecarlo`, `multiround`, `sweep`), the spacetime LUT
(`spacetime`), the circuit-level DEM (`dem`), the host decoders
(union-find `uf`, exact matching `mwpm` over `blossom`, with `calibrate`),
the dense stencil decoder (`device_uf`, its staged routes in
`device_uf_staged`), the defect-granular sparse decoder (`device_sparse`),
sliding-window streaming decoding on the host and the device
(`streaming`, `device_streaming`), parallel-window decoding
(`parallel_window`), and the qLDPC stack: batched BP+OSD (`bp`), the
two-sector DEM (`dem2`), circuit-level Tanner graphs (`bp_dem`) and
sliding-window BP (`bp_streaming`), and per-shot side information:
correlated two-pass matching (`correlated`), belief-matching
(`belief`) and exact maximum-likelihood decoding (`mld`); and the exact
per-observable fault distance of a matching graph (`fault_distance`)."""

from qcss_tpu_torch.decode.lut import (
    correct_errors,
    decode_corrections,
    detect_errors,
)
from qcss_tpu_torch.decode.montecarlo import (
    logical_error_rate,
    mc_decode_rounds,
    mc_decode_step,
    sample_depolarizing,
)
from qcss_tpu_torch.decode.sweep import error_rate_curve
from qcss_tpu_torch.decode.multiround import multiround_error_rate
from qcss_tpu_torch.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu_torch.decode.dem2 import TwoSectorDEM, build_two_sector_dem
from qcss_tpu_torch.decode.bp import (
    BPDecoder,
    bp_logical_error_rate,
    bp_phenomenological_error_rate,
    spacetime_tanner,
)
from qcss_tpu_torch.decode.bp_dem import (
    CircuitTanner,
    build_circuit_tanner,
    build_joint_circuit_tanner,
    circuit_bp_decoder,
    joint_circuit_bp_decoder,
)
from qcss_tpu_torch.decode.bp_streaming import (
    BPStreamingDecoder,
    CircuitBPStreamingDecoder,
)
from qcss_tpu_torch.decode.belief import BeliefMatchingDecoder
from qcss_tpu_torch.decode.correlated import (
    conditional_weights,
    correlated_logical_error_rate,
)
from qcss_tpu_torch.decode.mld import MLDecoder, mld_logical_error_rate
from qcss_tpu_torch.decode.device_sparse import (
    make_hybrid_obs_decoder,
    make_sparse_obs_decoder,
)
from qcss_tpu_torch.decode.device_streaming import (
    DeviceStreamingDecoder,
    stream_memory_rate,
    stream_memory_rate_dem,
)
from qcss_tpu_torch.decode.device_uf import DeviceUFDecoder, make_obs_decoder
from qcss_tpu_torch.decode.device_uf_staged import (
    decode_stencil_fused,
    decode_stencil_staged,
)
from qcss_tpu_torch.decode.spacetime import (
    detector_history,
    spacetime_check_matrix,
    spacetime_correction_lut,
)
from qcss_tpu_torch.decode.streaming import (
    StreamingDecoder,
    sample_phenomenological_stream,
)
from qcss_tpu_torch.decode.uf import (
    MatchingGraph,
    UFDecoder,
    graph_from_checks,
    spacetime_graph,
    uf_logical_error_rate,
    uf_phenomenological_error_rate,
)
from qcss_tpu_torch.decode.mwpm import MWPMDecoder, MWPMOracle
from qcss_tpu_torch.decode.parallel_window import (
    ParallelWindowDecoder,
    parallel_window_memory_rate,
)
from qcss_tpu_torch.decode import classical

__all__ = [
    "BPDecoder",
    "BeliefMatchingDecoder",
    "BPStreamingDecoder",
    "CircuitBPStreamingDecoder",
    "CircuitTanner",
    "DeviceStreamingDecoder",
    "DeviceUFDecoder",
    "MLDecoder",
    "MWPMDecoder",
    "MWPMOracle",
    "MatchingGraph",
    "ParallelWindowDecoder",
    "StreamingDecoder",
    "TwoSectorDEM",
    "UFDecoder",
    "bp_logical_error_rate",
    "bp_phenomenological_error_rate",
    "build_circuit_tanner",
    "build_joint_circuit_tanner",
    "build_two_sector_dem",
    "circuit_bp_decoder",
    "circuit_level_graph",
    "classical",
    "conditional_weights",
    "correct_errors",
    "correlated_logical_error_rate",
    "decode_corrections",
    "decode_stencil_fused",
    "decode_stencil_staged",
    "detect_errors",
    "detector_history",
    "error_rate_curve",
    "extraction_gate_list",
    "graph_from_checks",
    "joint_circuit_bp_decoder",
    "logical_error_rate",
    "make_hybrid_obs_decoder",
    "make_obs_decoder",
    "make_sparse_obs_decoder",
    "mc_decode_rounds",
    "mc_decode_step",
    "mld_logical_error_rate",
    "multiround_error_rate",
    "parallel_window_memory_rate",
    "sample_depolarizing",
    "sample_phenomenological_stream",
    "spacetime_check_matrix",
    "spacetime_correction_lut",
    "spacetime_graph",
    "spacetime_tanner",
    "stream_memory_rate",
    "stream_memory_rate_dem",
    "uf_logical_error_rate",
    "uf_phenomenological_error_rate",
]
