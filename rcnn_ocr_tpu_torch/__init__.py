"""rcnn_ocr_tpu_torch: the PyTorch/CUDA port of rcnn_ocr_tpu.

The JAX package ``rcnn_ocr_tpu`` is the reference; this package mirrors its
module paths and names, runs on an NVIDIA card (Hopper, ``sm_90a``) with
hand-written CUDA kernels where the JAX package had Pallas ones, and imports
nothing of JAX.  Importing it has no side effects.
"""

__version__ = "0.1.0"
