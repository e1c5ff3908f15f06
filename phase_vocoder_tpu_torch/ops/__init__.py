"""Signal-processing ops: plain torch twins and the wrappers of the CUDA kernels."""
