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
adjustment), clusterMNN (``cluster_mnn``), the linear engines
(``rescale_batches``, ``regress_batches``, ``no_correct``), multiBatchNorm,
the variance model and HVG selection, the diagnostics, the typed dispatch
API (``batch_correct`` and its ``*Params``) and the pipelines
(``quick_correct``, ``correct_experiments``, ``apply_multi``), and what
they run: kNN search, MNN detection and the correction math. Out of core:
CSR stores on disk (``CSRCells``, ``dense_blocks``,
``device_dense_blocks``) through the host C++ runtime
(``native/libbatchelor.cpp``, built with g++ at first use), the streamed PCA
(``multi_batch_pca_csr``), ``quick_correct_csr``, ``cluster_mnn_csr``,
``mnn_correct_csr``, ``rescale_batches_csr``, ``regress_batches_csr``, and
the command line (``python -m batchelor_torch``). The parallel layer
(``batchelor_torch.parallel``): one process per device over
``torch.distributed`` (NCCL on the card, gloo on the CPU), the cells mesh
(``make_cells_mesh``), the distributed merge step and PCA, ring
collectives and ``distributed_fast_mnn``, also behind the ``mesh=``
arguments of the out-of-core engines.
"""
from .convert import from_numpy, pca_to_numpy, result_to_numpy
from .correct.classic_mnn import mnn_correct
from .correct.cluster_mnn import ClusterMNNResult, cluster_mnn, cluster_mnn_csr, kmeans_clusters
from .correct.diagnostics import (
    MnnDeltaVarianceResult,
    cluster_abundance_test,
    cluster_abundance_var,
    fit_trend_var,
    mnn_delta_variance,
    mnn_delta_variance_blocked,
)
from .correct.dispatch import (
    BatchelorParams,
    ClassicMNNParams,
    FastMNNParams,
    NoCorrectParams,
    RegressParams,
    RescaleParams,
    batch_correct,
    register_correction,
)
from .correct.experiments import (
    QuickCorrectResult,
    SingleCellDataset,
    apply_multi,
    correct_experiments,
    quick_correct,
)
from .correct.fast_mnn import MergeStepInfo, MNNResult, fast_mnn, reduced_mnn
from .correct.fused import FusedMergeOutput, fused_merge_step
from .correct.outofcore import (
    CSRResidualOp,
    mnn_correct_csr,
    quick_correct_csr,
    regress_batches_csr,
    rescale_batches_csr,
)
from .correct.linear import LinearCorrectionResult, no_correct, regress_batches, rescale_batches
from .device import resolve_device
from .io.checkpoint import MergeCheckpointer, load_pca_stage, save_pca_stage
from .io.csr import CSRCells, dense_blocks, device_dense_blocks
from .ops.correction import average_correction, center_along_batch_vector, tricube_average
from .ops.cosine_norm import apply_cosine_norm, cosine_norm
from .ops.knn import KNNResult, query_knn
from .ops.lowrank import LowRankOp
from .ops.mutual_nn import MNNPairs, choose_k, find_mutual_nn, restricted_mnn
from .ops.normalization import MultiBatchNormResult, multi_batch_norm
from .ops.pca import MultiBatchPCAResult, multi_batch_pca
from .ops.pca_outofcore import multi_batch_pca_csr
from .ops.residual import ResidualOp
from .ops.stats import GeneVarResult, combine_var, get_top_hvgs, model_gene_var
from .parallel import distributed_fast_mnn, make_cells_mesh
from .utils.batching import (
    check_batch_consistency,
    check_restrictions,
    divide_into_batches,
    intersect_rows,
    reindex_pairings,
    restore_original_order,
)
from .utils.telemetry import MetricsRecorder, get_recorder, set_recorder, trace_span

__all__ = [
    "apply_cosine_norm",
    "apply_multi",
    "average_correction",
    "batch_correct",
    "BatchelorParams",
    "center_along_batch_vector",
    "check_batch_consistency",
    "check_restrictions",
    "choose_k",
    "ClassicMNNParams",
    "cluster_abundance_test",
    "cluster_abundance_var",
    "cluster_mnn",
    "cluster_mnn_csr",
    "ClusterMNNResult",
    "combine_var",
    "correct_experiments",
    "cosine_norm",
    "CSRCells",
    "CSRResidualOp",
    "dense_blocks",
    "device_dense_blocks",
    "distributed_fast_mnn",
    "divide_into_batches",
    "fast_mnn",
    "FastMNNParams",
    "find_mutual_nn",
    "fit_trend_var",
    "from_numpy",
    "fused_merge_step",
    "FusedMergeOutput",
    "GeneVarResult",
    "get_recorder",
    "get_top_hvgs",
    "intersect_rows",
    "kmeans_clusters",
    "KNNResult",
    "LinearCorrectionResult",
    "load_pca_stage",
    "LowRankOp",
    "make_cells_mesh",
    "MergeCheckpointer",
    "MergeStepInfo",
    "MetricsRecorder",
    "mnn_correct",
    "mnn_correct_csr",
    "mnn_delta_variance",
    "mnn_delta_variance_blocked",
    "MnnDeltaVarianceResult",
    "MNNPairs",
    "MNNResult",
    "model_gene_var",
    "multi_batch_norm",
    "multi_batch_pca",
    "multi_batch_pca_csr",
    "MultiBatchNormResult",
    "MultiBatchPCAResult",
    "no_correct",
    "NoCorrectParams",
    "pca_to_numpy",
    "query_knn",
    "quick_correct",
    "quick_correct_csr",
    "QuickCorrectResult",
    "reduced_mnn",
    "register_correction",
    "regress_batches",
    "regress_batches_csr",
    "RegressParams",
    "reindex_pairings",
    "rescale_batches",
    "rescale_batches_csr",
    "RescaleParams",
    "ResidualOp",
    "resolve_device",
    "restore_original_order",
    "restricted_mnn",
    "result_to_numpy",
    "save_pca_stage",
    "set_recorder",
    "SingleCellDataset",
    "trace_span",
    "tricube_average",
]
