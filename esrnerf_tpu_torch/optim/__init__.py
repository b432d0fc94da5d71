from esrnerf_tpu_torch.optim.adam import (Adam, AdamState,  # noqa: F401
                                         make_pervoxel_lr)
from esrnerf_tpu_torch.optim.schedule import (CosineLR,  # noqa: F401
                                             exp_decay_factor)
