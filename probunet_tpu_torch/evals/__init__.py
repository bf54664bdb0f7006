"""Evaluation suite (port of ``probunet_tpu/evals``): the ensemble metrics,
the PSD and histogram analyses, the streamed accumulator, the GEV
extreme-value toolkit and the WMSE weight-function analysis."""

from probunet_tpu_torch.evals.metrics import (
    compute_mae,
    crps_over_groundtruth,
    ensemble_spread,
    mae_over_groundtruth,
    residual_contribution,
)
from probunet_tpu_torch.evals.psd import psd, psd_over_dataset
from probunet_tpu_torch.evals.streaming import EvalAccumulator
from probunet_tpu_torch.evals.histograms import log_histogram
from probunet_tpu_torch.evals.gev import (
    compute_annual_block_maxima,
    gev_fit,
    gev_parametric_bootstrap,
    gev_return_level,
    get_empirical_return_periods,
    model_ensemble_analysis,
    return_level_analysis,
)
from probunet_tpu_torch.evals.weights import weight_function_analysis

__all__ = [
    "crps_over_groundtruth",
    "mae_over_groundtruth",
    "compute_mae",
    "ensemble_spread",
    "residual_contribution",
    "psd",
    "psd_over_dataset",
    "EvalAccumulator",
    "log_histogram",
    "compute_annual_block_maxima",
    "gev_fit",
    "gev_return_level",
    "gev_parametric_bootstrap",
    "get_empirical_return_periods",
    "model_ensemble_analysis",
    "return_level_analysis",
    "weight_function_analysis",
]
