"""PipeCNN in PyTorch for an NVIDIA H100: the port of the JAX package
``repro``, with hand-written CUDA kernels for the fused pipeline.

Entry point: ``repro_torch.pipeline.compile_cnn(cfg, spec).forward(x)``
and ``.serve(requests)``. Importing this package imports neither JAX nor
the JAX package.
"""
