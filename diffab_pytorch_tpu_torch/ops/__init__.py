"""Hand-written CUDA kernels: build, binding, wrappers and plain versions."""
