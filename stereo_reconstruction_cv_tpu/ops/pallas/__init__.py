"""Hand-written Pallas kernels for the dense-stereo hot path (GPU)."""
