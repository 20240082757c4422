"""The port's CUDA kernels (csrc/), their builder and their Python wrappers.

Importing the package registers the ``torch.library`` custom ops that the
wrappers call (``s2i::logmel``, ``s2i::logmel_frames``, ``s2i::gru_scan``,
``s2i::gru_scan_bwd``), as a loaded ``torch.export`` program needs them.
"""

from s2i_tpu_torch.ops import gru_kernel, mel_kernel  # noqa: F401

