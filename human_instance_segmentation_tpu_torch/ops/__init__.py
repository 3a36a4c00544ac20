"""Core ops of the PyTorch port: sampling, norms, morphology and the
hand-written CUDA kernels (``cuda_head``, ``cuda_roi_align``, ``cuda_tail``,
``cuda_kernels`` and the s8 conv of ``quant``, built by ``_build``)."""
