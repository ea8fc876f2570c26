"""Device compute of the port: init correlation, greedy loop (plain PyTorch
and the CUDA kernel), integer decode (plain and the CUDA kernel), and the
batch pipeline.  Kernels build on first launch, never at import."""
