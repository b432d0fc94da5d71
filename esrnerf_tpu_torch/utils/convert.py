"""Parameter conversion between the JAX reference and the port.

The reference's parameters (from its ``init_params`` or a checkpoint) are a
nested dict of arrays with the same names and layouts as the port's, so
conversion is a leaf-wise copy. Moving one set of parameters across is the
only way both sides compute the same thing: the JAX PRNG and torch's
generators give different numbers from the same seed.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from esrnerf_tpu_torch.utils.device import resolve_device


def params_from_jax(np_params: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of arrays (numpy or anything ``np.asarray`` takes) ->
    the same nested dict of f32/int tensors on ``device``."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.as_tensor(np.array(v), device=dev)

    return conv(np_params)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
