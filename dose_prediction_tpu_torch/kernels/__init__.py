"""Hand-written Hopper kernels (CUDA C++ sources in ../csrc) for the TPU
kernels of dose_prediction_tpu/kernels. Each wrapper uses its kernel's plain
PyTorch version only for tensors on the CPU."""
