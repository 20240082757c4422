"""s2i_tpu_torch: the PyTorch/CUDA port of direct speech-to-image translation.

The serving path of the JAX package (``s2i_tpu``), rebuilt on PyTorch for an
NVIDIA Hopper card:

    wav → audio.frontend.extract_features   (log-mel: csrc/mel_fused.cu)
        → models.encoder.SpeechEncoder      (bi-GRU: csrc/gru_fwd.cu)
        → models.ca_net.CANet μ
        → models.generator.GNet             → top-scale image [B, S, S, 3]

Entry points (``pipeline.SpeechToImage``, ``serving.make_server``,
``audio.frontend.extract_features``) run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; without a card they raise instead of
drifting to the CPU. On a CPU tensor every kernel wrapper runs its plain
PyTorch version, which is how the tests hold the port against the JAX
package. The package imports nothing of JAX or of ``s2i_tpu``.
"""
