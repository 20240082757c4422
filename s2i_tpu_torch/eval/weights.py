"""Load torch InceptionV3 weights into the port's InceptionV3, the
counterpart of ``s2i_tpu/eval/weights.py``.

The IS/FID protocol scores with StackGAN's Inception fine-tuned on CUB or
Oxford; those weights, and ImageNet's, are a user's asset: the repository
holds none and fetches none. Any torchvision-layout ``inception_v3``
state_dict (the layout pytorch-fid uses too) loads by name, since the
port's module names are torchvision's.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from s2i_tpu_torch.models.inception import InceptionV3


def load_torch_inception(state_dict: Mapping[str, Any], num_classes: int | None = None) -> dict[str, torch.Tensor]:
    """A torchvision-layout state_dict (name → tensor or array, e.g. from
    ``torch.load``) → the port's InceptionV3 state_dict, float32.

    The ``AuxLogits.*`` head and the ``num_batches_tracked`` counters are
    dropped, as the JAX mapper drops them; every other key must be one of
    the model's with its shape, and every key of the model must be there
    (``num_classes``: the ``fc`` rows expected, default whatever the
    dict's ``fc.weight`` has)."""
    sd = {
        k: torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v), dtype=torch.float32)
        for k, v in state_dict.items()
        if not k.startswith("AuxLogits.") and not k.endswith("num_batches_tracked")
    }
    if "fc.weight" not in sd:
        raise KeyError("the state_dict has no fc.weight: not an inception_v3 state_dict")
    n = int(sd["fc.weight"].shape[0]) if num_classes is None else num_classes
    InceptionV3(n).load_state_dict(sd)  # strict: raises on a missing, unexpected or misshapen key
    return sd
