"""Core ops of the PyTorch port: sampling, norms, morphology and the
hand-written CUDA kernels (``cuda_head``, ``cuda_roi_align``, built by
``_build``)."""
