"""theanet_tpu_torch — the PyTorch + CUDA port of ``theanet_tpu``.

Same module names and paths as the JAX package, so each counterpart is easy
to find. The package imports ``torch`` and never JAX or ``theanet_tpu``: the
machine with the GPU has no JAX. Checkpoints are pickles of numpy arrays in
the reference ``{layers, training_params, allwts}`` structure, so either
package reads the other's.

First slice: the flagship ``mnist_cnn.prms`` net trained by one hand-written
CUDA kernel per epoch (``ops/megastep.py`` + ``csrc/megastep.cu``), with the
per-layer path for nets the fused matcher declines. The device comes from
``THEANET_TORCH_DEVICE`` (default ``cuda``; see ``device.py``).
"""

__version__ = "0.1.0"
