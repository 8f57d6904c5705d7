"""Graph tables, MLP-block math, divergence estimators and the CUDA kernels."""
