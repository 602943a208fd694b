"""batchelor_torch: the PyTorch/CUDA port of batchelor_tpu for one NVIDIA H100.

Every Pallas kernel of the JAX package (its two in ``ops/`` and the two probe
kernels in ``benchmarks/``) has a hand-written CUDA counterpart here
(``csrc/``, built with nvcc at first use into ``build/``); the rest is plain
PyTorch. Entry points run on the CUDA device unless called with
``device="cpu"``, where each kernel wrapper uses its plain PyTorch version.

Ported so far: ``fast_mnn`` from gene space (cosine normalization,
``multi_batch_pca``, the merge), the reduced-coordinate merge
(``reduced_mnn``) with per-step checkpoints (``MergeCheckpointer``, the PCA
stage's ``save_pca_stage``/``load_pca_stage``), the fused merge step that
never waits for the host (``fused_merge_step``), classic mnnCorrect
(``mnn_correct``: Gaussian smoothing, bio-span removal, variance
adjustment), and what they run: kNN search, MNN detection and the
correction math.
"""
from .convert import from_numpy, pca_to_numpy, result_to_numpy
from .correct.classic_mnn import mnn_correct
from .correct.fast_mnn import MergeStepInfo, MNNResult, fast_mnn, reduced_mnn
from .correct.fused import FusedMergeOutput, fused_merge_step
from .device import resolve_device
from .io.checkpoint import MergeCheckpointer, load_pca_stage, save_pca_stage
from .ops.cosine_norm import cosine_norm
from .ops.knn import KNNResult, query_knn
from .ops.lowrank import LowRankOp
from .ops.mutual_nn import MNNPairs, find_mutual_nn, restricted_mnn
from .ops.pca import MultiBatchPCAResult, multi_batch_pca
from .utils.telemetry import MetricsRecorder, get_recorder, set_recorder, trace_span

__all__ = [
    "FusedMergeOutput",
    "KNNResult",
    "LowRankOp",
    "MergeCheckpointer",
    "MNNPairs",
    "MNNResult",
    "MergeStepInfo",
    "MetricsRecorder",
    "MultiBatchPCAResult",
    "cosine_norm",
    "fast_mnn",
    "find_mutual_nn",
    "from_numpy",
    "fused_merge_step",
    "get_recorder",
    "load_pca_stage",
    "mnn_correct",
    "multi_batch_pca",
    "pca_to_numpy",
    "query_knn",
    "reduced_mnn",
    "resolve_device",
    "restricted_mnn",
    "result_to_numpy",
    "save_pca_stage",
    "set_recorder",
    "trace_span",
]
