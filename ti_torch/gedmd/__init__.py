"""gEDMD with random Fourier features (numpy; a copy of ti_tpu/gedmd)."""

from ti_torch.gedmd.rff import (
    sample_rff_gaussian,
    sample_rff_gauss_periodic,
    rff_matrices_koopman,
    rff_gram_generator,
    rff_ml_nonreversible,
    rff_ml_reversible,
    spectral_analysis_rff_koopman,
    spectral_analysis_rff_generator,
    cv_koopman_rff,
    cv_generator_rff,
    bootstrap_generator_eigenvalues,
    whitening_transform,
    filter_ev,
    split_by_lag,
)

__all__ = [
    "sample_rff_gaussian",
    "sample_rff_gauss_periodic",
    "rff_matrices_koopman",
    "rff_gram_generator",
    "rff_ml_nonreversible",
    "rff_ml_reversible",
    "spectral_analysis_rff_koopman",
    "spectral_analysis_rff_generator",
    "cv_koopman_rff",
    "cv_generator_rff",
    "bootstrap_generator_eigenvalues",
    "whitening_transform",
    "filter_ev",
    "split_by_lag",
]
