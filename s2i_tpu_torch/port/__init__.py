"""Checkpoint porters: reference torch checkpoints in and out of the port,
the counterpart of ``s2i_tpu/port``.

- :mod:`s2i_tpu_torch.port.stackgan_torch`: ``netG.pth`` / ``netD*.pth``
  (StackGAN-v2 lineage) to the port's ``GNet`` / ``DNet`` state_dicts and
  back (commands: ``port-torch-gan``, ``export-torch-gan``);
- :mod:`s2i_tpu_torch.port.audio_encoder_torch`: a structural port of
  ``audio_encoder/`` speech-encoder checkpoints (topology-matched, loud
  failure; validate outputs);
- the Inception weights' reader lives in :mod:`s2i_tpu_torch.eval.weights`.
"""

from s2i_tpu_torch.port.audio_encoder_torch import port_encoder  # noqa: F401
from s2i_tpu_torch.port.stackgan_torch import (  # noqa: F401
    export_dnet,
    export_gnet,
    load_torch_state_dict,
    port_dnet,
    port_dnet_scale,
    port_gnet,
)
