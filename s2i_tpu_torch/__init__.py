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
    cli.run_eval → eval.InceptionFeatures (models.inception.InceptionV3 at
        299 px) → eval.inception_score / eval.fid; cli.run_retrieval →
        eval.retrieval; cli.run_inception_finetune → eval.finetune

Both training loops checkpoint the full train state (utils.checkpoint,
``torch.save`` files readable on the card and the CPU) and resume exactly
where they stopped; ``SpeechToImage.from_checkpoints`` serves what they
trained. Real data comes from a StackGAN tree (data.stackgan, with the C++
JPEG loader of native/), through a prefetch thread that copies batches to
the card from pinned buffers (data.pipeline); cli.run_embedding_extraction
writes the speech embeddings the GAN trains on. ``python -m s2i_tpu_torch``
(entrypoints.py) runs pretrain / extract / train / sample / eval /
finetune-inception from the command line.

``ops.mel_kernel.logmel_framed`` (csrc/mel_framed.cu) computes the log-mel
from pre-framed rows, for the frontend A/B only. The kernels' wrappers call
``torch.library`` custom ops (``s2i::logmel``, ``s2i::logmel_frames``,
``s2i::gru_scan`` with its backward ``s2i::gru_scan_bwd``), registered when
``s2i_tpu_torch.ops`` is imported.

    export.export_pipeline(pipe, dir) → pipeline.ServeProgram saved with
        torch.export (weights inside, the kernels as op nodes) + meta.json
    export.load(dir) → LoadedPipeline: SpeechToImage's serving surface,
        no model code imported; serving.make_server takes it

``python -m s2i_tpu_torch`` (entrypoints.py) also runs export / serve
[--artifact] / speech-to-image.

    port.port_gnet / port_dnet / port_encoder: the reference project's
        netG.pth / netD*.pth / speech-encoder .pth → the port's state_dicts;
        port.export_gnet / export_dnet: the way back (the port-torch-gan and
        export-torch-gan commands, cli.run_port_gan / run_export_gan)

Entry points (``pipeline.SpeechToImage`` and its ``from_checkpoints``,
``export.export_pipeline``, ``export.load``,
``serving.make_server``, ``audio.frontend.extract_features``,
``train.encoder.init_encoder_state``, ``train.gan.init_state``,
``train.loop.GanTrainer``, ``cli.run_encoder_pretrain``,
``cli.run_embedding_extraction``, ``cli.run_gan_training``,
``cli.run_sampling``, ``eval.InceptionFeatures``,
``eval.retrieval_metrics``, ``eval.finetune.init_inception_state``,
``cli.run_eval``, ``cli.run_retrieval``, ``cli.run_inception_finetune``, ``cli.run_port_gan``,
the command line) run on ``device="cuda"`` unless
the caller passes ``device="cpu"`` (``--device cpu``); without a card
they raise instead of drifting to the CPU.
On a CPU tensor every kernel wrapper runs its plain PyTorch version, which
is how the tests hold the port against the JAX package. The package imports
nothing of JAX or of ``s2i_tpu``.
"""
