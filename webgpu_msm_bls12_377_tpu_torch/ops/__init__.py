"""Plain PyTorch forms and CUDA kernel wrappers of the MSM stages."""
