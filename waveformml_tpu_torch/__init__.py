"""PyTorch + CUDA port of waveformml_tpu for NVIDIA Hopper (H100).

The JAX package ``waveformml_tpu`` stays the reference; this package keeps
its module names so each counterpart is easy to find. It imports torch and
numpy only. What it ports so far is the flagship sparse PSD classifier
(``config/examples/SubMPSD.json``: ``LitPSD`` + ``SubMPSDNet``), served
(``inference.model.InferenceModel``: a CUDA graph per batch layout, on-device
pre- and post-processing) and trained on one device
(``engineering.trainer.Trainer``: masked cross entropy, the JAX package's
optimizers and epoch schedulers, clipping, accumulation, early stopping,
resume, ``lr_find``; masked BatchNorm statistics; ``datasets.data_module``
loaders), from HDF5 class directories (``datasets.pulse_dataset``,
``PSDDataModule``; h5py is imported only when files are read) through the
CLI (``python -m waveformml_tpu_torch.main``) to a checkpoint, in float32
or ``half_precision`` (``SubMPSD_w128.json``), and the per-waveform DSP
feature op; and the per-segment regressors (``LitZ``, ``LitEZ``,
``LitSegQuantifier``, ``LitSegClassifier``: ``SingleEndedZCNN.json`` on
the dense-grid sparse ops of ``ops.sparse_conv``, whose convs are cuDNN's
in float32, ``SegQuantifier.json`` on the row path); and the sparse event
classifiers without waveform models (``SPConvNet``, ``DenseConvNet``,
``ExtractedFeatureConvNet`` and 2D ``SCNet`` over the config ``algorithm``
DSL of ``models.algorithm`` and ``nn.layers``, checked by
``utils.model_validation``: ``GEP.json``, ``IoniClassifierCNN.json``,
``DensePSD.json``, ``OPs3ns_SCNet.json`` on the row path); through five
kernels written by hand in CUDA C++:

* ``ops.row_conv.subm_conv_rows``           -- K1, gather-fused TF32 GEMM (forward,
  and the feature gradient with the reversed, transposed kernel)
* ``ops.row_conv.subm_conv_rows_wgrad``     -- K4, the conv's kernel and bias gradients
* ``ops.site_head.site_grouped_matmul``     -- K2, grouped GEMM + scatter-add
* ``ops.site_head.site_grouped_matmul_bwd`` -- K5, its backward
* ``ops.waveform_features.waveform_features`` -- K3, per-row scan

Each kernel has a plain PyTorch version in the same module and is a
``torch.library`` custom op (``torch.ops.waveformml.<name>``): the
dispatcher runs the plain version for CPU tensors and launches the kernel
(or raises) for CUDA tensors, and a fake kernel lets ``torch.export`` trace
a forward through it (``engineering.trainer.Trainer.export_model``,
``load_exported``; ``python -m waveformml_tpu_torch.evaluate --script``).
"""
