"""Training data of the port: the synthetic fixture corpora (numpy only)."""

from s2i_tpu_torch.data.synthetic import SyntheticGanDataset, SyntheticSpeechDataset, synthetic_wavs

__all__ = ["SyntheticGanDataset", "SyntheticSpeechDataset", "synthetic_wavs"]
