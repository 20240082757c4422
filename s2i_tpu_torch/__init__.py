"""s2i_tpu_torch: the PyTorch/CUDA port of direct speech-to-image translation.

The serving path, the encoder distillation pretraining and the GAN training
(frozen embeddings and joint finetune) of the JAX package (``s2i_tpu``),
rebuilt on PyTorch for an NVIDIA Hopper card:

    wav → audio.frontend.extract_features   (log-mel: csrc/mel_fused.cu)
        → models.encoder.SpeechEncoder      (bi-GRU: csrc/gru_fwd.cu,
                                             its gradient csrc/gru_bwd.cu)
        → models.ca_net.CANet μ
        → models.generator.GNet             → top-scale image [B, S, S, 3]

    cli.run_encoder_pretrain → train.encoder.encoder_train_step:
        SpeechEncoder in train mode → train.losses.distillation_loss → Adam
    cli.run_gan_training → train.loop.GanTrainer → train.gan.train_step:
        [SpeechEncoder →] CA sample → GNet → models.discriminator.DNet ×3,
        D phase and G phase with Adam, EMA
    cli.run_sampling → GanTrainer.sample_to_dir: BN recalc under the EMA
        (train.gan.bn_recalc) → train.gan.sample → PNG tree

Both training loops checkpoint the full train state (utils.checkpoint,
``torch.save`` files readable on the card and the CPU) and resume exactly
where they stopped; ``SpeechToImage.from_checkpoints`` serves what they
trained.

``ops.mel_kernel.logmel_framed`` (csrc/mel_framed.cu) computes the log-mel
from pre-framed rows, for the frontend A/B only.

Entry points (``pipeline.SpeechToImage`` and its ``from_checkpoints``,
``serving.make_server``, ``audio.frontend.extract_features``,
``train.encoder.init_encoder_state``, ``train.gan.init_state``,
``train.loop.GanTrainer``, ``cli.run_encoder_pretrain``,
``cli.run_gan_training``, ``cli.run_sampling``) run on ``device="cuda"``
unless the caller passes
``device="cpu"``; without a card they raise instead of drifting to the CPU.
On a CPU tensor every kernel wrapper runs its plain PyTorch version, which
is how the tests hold the port against the JAX package. The package imports
nothing of JAX or of ``s2i_tpu``.
"""
