"""The plain reference of the speech-to-image model: float32 PyTorch with
TF32 off, no kernel, no cache, no batching tricks. It imports nothing of
the program under test and takes nothing that the program made: the
benchmark hands both sides the same seeded inputs and weights, and the
reference works everything else out again.

Modules: ``precision`` (the float32 reference and the lower-precision
control), ``audio`` (log-mel frontend), ``models`` (speech encoder, CA,
the StackGAN-v2 generator and discriminators) and ``train`` (the GAN
step, the encoder distillation step, Adam).
"""
