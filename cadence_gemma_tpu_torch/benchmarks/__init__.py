"""Timing labs of the port's kernels (``python -m
cadence_gemma_tpu_torch.benchmarks.kernel_lab``)."""
