"""Dataset contract; the port's copy of ``esrnerf_tpu/data/base.py``.

Datasets preprocess everything into a host-side numpy ray cache
(``all_data``): per-ray origins/dirs/viewdirs/colors/light-modes, flattened
across images for the train phase. The pool stays in host memory; the
trainer copies each fixed-size batch to the device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Tuple

import numpy as np

# light-mode vocabulary (reference utils2/utils.py:32-38)
LightDict = {
    "off": 0,
    "on": 1,
    "i_change": 2,
    "c_change": 3,
    "ic_change": 4,
}


class DataClass(ABC):
    def __init__(self, cfg, phase: str):
        self.cfg = cfg
        self.phase = phase
        self.root = cfg.data["root"]
        self.scene = cfg.data["scene"]
        self.resize = cfg.data["resize"]
        self.batch_type = cfg.data["batch_type"]
        self.white_bg = cfg.data["white_bg"]
        if self.batch_type != "nerf":
            raise NotImplementedError("only nerf-style ray batching is supported")

    @property
    @abstractmethod
    def image_size(self) -> Tuple[int, int]:
        """(width, height)"""

    @property
    @abstractmethod
    def focal_length(self) -> float: ...

    @property
    @abstractmethod
    def all_data(self) -> Dict[str, np.ndarray]: ...

    @property
    @abstractmethod
    def near_far(self) -> Tuple[float, float]: ...

    @property
    @abstractmethod
    def scale_mat(self) -> np.ndarray: ...

    @abstractmethod
    def __len__(self) -> int: ...

    @abstractmethod
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]: ...

    @abstractmethod
    def seek(self, index: int) -> Dict[str, Any]:
        """Raw, unprocessed record."""

    @abstractmethod
    def preprocess(self) -> None: ...
