"""End-to-end inference: speech waveform → image, the counterpart of
``s2i_tpu/pipeline.py``:

    wav → log-mel frontend → SpeechEncoder → CA (μ) → GNet → RGB

    pipe = SpeechToImage(cfg, enc_sd, g_sd)          # state_dicts (bridge.py)
    pipe = SpeechToImage.from_checkpoints(cfg, enc_ckpt_dir, gan_ckpt_dir)  # what the port trained
    images = pipe.generate(wavs, wav_lens, seed=0)   # [B, S, S, 3]

The device program behind ``generate`` is :class:`ServeProgram`, a module
of (wavs, wav_lens, z) → images; ``export.export_pipeline`` saves that same
module with ``torch.export``. The noise z is drawn outside it, from a
``torch.Generator`` seeded per call, because ``torch.export`` cannot trace
a generator.
"""

from __future__ import annotations

import numpy as np
import torch

from s2i_tpu_torch.audio.frontend import extract_features, frontend_params_from_cfg
from s2i_tpu_torch.device import compute_dtype, draw_z, resolve_device
from s2i_tpu_torch.models.encoder import SpeechEncoder
from s2i_tpu_torch.models.generator import GNet
from s2i_tpu_torch.utils.checkpoint import CheckpointManager


def build_encoder(cfg, joint: bool = False) -> SpeechEncoder:
    """The encoder a checkpoint of this cfg holds. The joint (encoder inside
    the GAN state) one has "SAME" padding and no class head, as the JAX
    package builds it."""
    e = cfg.ENCODER
    return SpeechEncoder(
        n_mels=int(cfg.AUDIO.N_MFCC if cfg.AUDIO.FEATURE == "mfcc" else cfg.AUDIO.N_MELS),
        emb_dim=int(cfg.TEXT.DIMENSION),
        conv_channels=tuple(e.CONV_CHANNELS),
        conv_kernel=int(e.CONV_KERNEL),
        conv_stride=int(e.CONV_STRIDE),
        conv_padding="SAME" if joint else str(e.CONV_PADDING),
        rnn_hidden=int(e.RNN_HIDDEN),
        rnn_layers=int(e.RNN_LAYERS),
        bidirectional=bool(e.BIDIRECTIONAL),
        pool=str(e.POOL),
        n_classes=0 if joint or not bool(e.CLS_HEAD) else int(e.N_CLASSES),
        norm_out=bool(e.NORM_OUT),
        dtype=compute_dtype(cfg),
    )


def build_generator(cfg) -> GNet:
    return GNet(
        gf_dim=int(cfg.GAN.GF_DIM),
        z_dim=int(cfg.GAN.Z_DIM),
        c_dim=int(cfg.GAN.EMBEDDING_DIM),
        t_dim=int(cfg.TEXT.DIMENSION),
        branch_num=int(cfg.TREE.BRANCH_NUM),
        num_res=int(cfg.GAN.R_NUM),
        dtype=compute_dtype(cfg),
        up_mode=str(cfg.GAN.UPSAMPLE_MODE),
    )


class ServeProgram(torch.nn.Module):
    """wav → image on the device: the frontend (K1), the encoder (K2), CA's
    μ, G's images at ``stage``, NHWC, quantized to [0, 255] bytes for
    ``output_dtype="uint8"`` (else [-1, 1] float32). ``forward(wavs
    [B, n_samples] float32, wav_lens [B] int, z [B, Z_DIM] float32)``."""

    def __init__(self, encoder: torch.nn.Module, g: torch.nn.Module, p, stage: int, output_dtype: str):
        super().__init__()
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype {output_dtype!r}: float32 or uint8")
        self.encoder = encoder
        self.g = g
        self.p = p
        self.stage = stage
        self.output_dtype = output_dtype

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        feats, mask = extract_features(wavs, self.p, wav_len=wav_lens, device=wavs.device)
        out = self.encoder(feats, mask)
        emb = out[0] if isinstance(out, tuple) else out
        mu, _ = self.g.ca_net(emb)
        img = self.g(z, mu, n_stages=self.stage + 1)[self.stage].permute(0, 2, 3, 1)  # NHWC
        if self.output_dtype == "uint8":
            return torch.clamp((img + 1.0) * 127.5 + 0.5, 0.0, 255.0).to(torch.uint8)
        return img.contiguous()


def _load(module: torch.nn.Module, state_dict: dict) -> None:
    module.load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}, strict=True
    )


class SpeechToImage:
    """wav → image on ``device`` (the card unless the caller passes "cpu").

    ``enc_state_dict`` / ``g_state_dict`` come from ``bridge`` (or from
    ``state_dict()`` of modules built by :func:`build_encoder` /
    :func:`build_generator`); ``joint`` says the encoder came from a joint
    checkpoint. Computes in ``DTYPE.COMPUTE`` (``device.compute_dtype``;
    the frontend in float32, TF32 off, see ``device.resolve_device``) and
    returns float32 images.
    """

    def __init__(self, cfg, enc_state_dict: dict, g_state_dict: dict,
                 joint: bool = False, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.p = frontend_params_from_cfg(cfg.AUDIO)
        self.z_dim = int(cfg.GAN.Z_DIM)
        self.branch_num = int(cfg.TREE.BRANCH_NUM)
        self.encoder = build_encoder(cfg, joint)
        self.g = build_generator(cfg)
        _load(self.encoder, enc_state_dict)
        _load(self.g, g_state_dict)
        self.encoder.to(self.device).eval()
        self.g.to(self.device).eval()
        self._programs: dict[tuple[int, str], ServeProgram] = {}

    @classmethod
    def from_checkpoints(cls, cfg, encoder_ckpt: str | None, gan_ckpt: str, use_ema: bool = True,
                         device: str | torch.device = "cuda") -> "SpeechToImage":
        """The pipeline of the port's checkpoint directories (``<run>/ckpt``
        of ``cli.run_encoder_pretrain`` and ``cli.run_gan_training``; the
        latest checkpoint of each), served as the JAX package serves its
        own: G's EMA weights when ``use_ema`` and the run kept an EMA, with
        G's running statistics. A joint checkpoint (``TRAIN.JOINT_FT``)
        carries its finetuned encoder, which is the one served (``encoder_ckpt``
        is not read and may be None); a frozen one needs ``encoder_ckpt``."""
        joint = bool(cfg.TRAIN.JOINT_FT)
        if not joint and not encoder_ckpt:
            raise ValueError("encoder_ckpt is required unless cfg.TRAIN.JOINT_FT is on "
                             "(joint GAN checkpoints embed the finetuned encoder)")
        restored = CheckpointManager(gan_ckpt).restore_latest_raw()
        if restored is None:
            raise FileNotFoundError(f"no GAN checkpoint in {gan_ckpt}")
        gan_sd = restored[0]
        if (gan_sd["enc"] is not None) != joint:
            raise ValueError(f"{gan_ckpt} holds a {'joint' if gan_sd['enc'] is not None else 'frozen'} "
                             f"GAN state; cfg.TRAIN.JOINT_FT is {joint}")
        g_sd = dict(gan_sd["g"])
        if use_ema:
            g_sd.update(gan_sd["ema"])
        if joint:
            enc_sd = gan_sd["enc"]
        else:
            restored = CheckpointManager(encoder_ckpt).restore_latest_raw()
            if restored is None:
                raise FileNotFoundError(f"no encoder checkpoint in {encoder_ckpt}")
            enc_sd = restored[0]["model"]
        return cls(cfg, enc_sd, g_sd, joint=joint, device=device)

    def generate(self, wavs, wav_lens=None, seed: int = 0, stage: int = -1,
                 output_dtype: str = "float32", z=None) -> np.ndarray:
        """wavs [B, n_samples] float32 in [-1, 1] → images [B, S, S, 3] at
        ``stage`` (-1 = highest resolution): [-1, 1] floats, or [0, 255]
        bytes quantized on the device for ``output_dtype="uint8"``."""
        out = self.generate_async(wavs, wav_lens, seed, stage, output_dtype, z)
        return out.cpu().numpy()

    @torch.inference_mode()
    def generate_async(self, wavs, wav_lens=None, seed: int = 0, stage: int = -1,
                       output_dtype: str = "float32", z=None) -> torch.Tensor:
        """:meth:`generate` without the host sync: returns the result tensor
        on the device once the work is queued on the current stream.
        ``z`` [B, Z_DIM] replaces the noise drawn from ``seed``."""
        if not -self.branch_num <= stage < self.branch_num:
            raise ValueError(
                f"stage {stage} out of range for BRANCH_NUM={self.branch_num} "
                f"(valid: {-self.branch_num}..{self.branch_num - 1}, -1 = highest)"
            )
        stage %= self.branch_num
        wavs = torch.as_tensor(wavs, dtype=torch.float32).to(self.device, non_blocking=True)
        if wav_lens is None:
            wav_lens = torch.full((wavs.shape[0],), wavs.shape[1], dtype=torch.int32)
        wav_lens = torch.as_tensor(wav_lens, device=self.device)
        if z is None:
            z = draw_z(seed, wavs.shape[0], self.z_dim, self.device)
        else:
            z = torch.tensor(np.asarray(z), dtype=torch.float32, device=self.device)
        return self.program(stage, output_dtype)(wavs, wav_lens, z)

    def program(self, stage: int = -1, output_dtype: str = "float32") -> ServeProgram:
        """The device program of :meth:`generate_async` at ``stage`` and
        ``output_dtype``, on this pipeline's modules: built once for each."""
        key = (stage % self.branch_num, output_dtype)
        if key not in self._programs:
            self._programs[key] = ServeProgram(self.encoder, self.g, self.p, *key)
        return self._programs[key]

    def generate_files(self, wav_paths: list[str], out_paths: list[str],
                       seed: int = 0) -> None:
        """wav files → PNG files (host IO + one device pass)."""
        from PIL import Image

        from s2i_tpu_torch.audio.wavio import read_wav, resample_linear

        wavs = np.zeros((len(wav_paths), self.p.max_samples), np.float32)
        lens = np.zeros(len(wav_paths), np.int32)
        for i, path in enumerate(wav_paths):
            x, sr = read_wav(path)
            x = resample_linear(x, sr, self.p.sample_rate)
            m = min(len(x), self.p.max_samples)
            wavs[i, :m] = x[:m]
            lens[i] = m
        imgs = self.generate(wavs, lens, seed, output_dtype="uint8")
        for img, out in zip(imgs, out_paths):
            Image.fromarray(img).save(out)
