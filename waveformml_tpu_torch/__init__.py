"""PyTorch + CUDA port of waveformml_tpu for NVIDIA Hopper (H100).

The JAX package ``waveformml_tpu`` stays the reference; this package keeps
its module names so each counterpart is easy to find. It imports torch and
numpy only. What it ports so far is the serving path of the flagship sparse
PSD classifier (``config/examples/SubMPSD.json``: ``LitPSD`` +
``SubMPSDNet``) and the per-waveform DSP feature op, through three kernels
written by hand:

* ``ops.row_conv.subm_conv_rows``        -- CUDA C++ gather-fused TF32 GEMM
* ``ops.site_head.site_grouped_matmul``  -- CUDA C++ grouped GEMM + scatter-add
* ``ops.waveform_features.waveform_features`` -- CUDA C++ per-row scan

Each kernel has a plain PyTorch version in the same module: the wrapper uses
it for CPU tensors and launches the kernel (or raises) for CUDA tensors.
"""
