from esrnerf_tpu_torch.optim.adam import Adam, AdamState  # noqa: F401
from esrnerf_tpu_torch.optim.schedule import CosineLR  # noqa: F401
