"""Ray batch sampler; the port's copy of ``BatchSampler`` from
``esrnerf_tpu/data/sampler.py`` (numpy only).

An epoch-free shuffled batcher over the preloaded ray pool, checkpointable
via ``(batch_st, data_idxs)``. Shuffling uses an explicit
``np.random.Generator`` seeded like the JAX package's, so both give the
same batches for a seed. The pool lives in host memory; ``sample()``
returns numpy slices that the trainer copies to the device. The two-pool
sampler of the LTS and PDRA stages is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class BatchSampler:
    def __init__(
        self,
        cfg,
        data: Dict[str, np.ndarray],
        keys: List[str],
        batch_size: int,
        batch_st: int = 0,
        data_idxs: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.keys = keys
        self.batch_size = batch_size
        self.batch_st = batch_st
        self.rng = np.random.default_rng(seed)

        self.data_idxs = (
            np.arange(len(data[keys[0]])) if data_idxs is None else np.asarray(data_idxs)
        )
        self.data = {k: np.ascontiguousarray(data[k][self.data_idxs]) for k in keys}

    @property
    def data_num(self) -> int:
        return len(self.data_idxs)

    def shuffle(self) -> None:
        order = self.rng.permutation(self.data_num)
        self.data_idxs = self.data_idxs[order]
        for k in self.keys:
            self.data[k] = np.ascontiguousarray(self.data[k][order])
        self.batch_st = 0

    def filter(self, mask: np.ndarray) -> None:
        mask = np.asarray(mask, dtype=bool)
        for k in self.keys:
            self.data[k] = np.ascontiguousarray(self.data[k][mask])
        self.data_idxs = self.data_idxs[mask]

    def sample(self) -> Dict[str, np.ndarray]:
        b_en = self.batch_st + self.batch_size
        if b_en > self.data_num:
            self.shuffle()
            b_en = self.batch_size
        b_st = self.batch_st
        self.batch_st = b_en
        return {k: self.data[k][b_st:b_en] for k in self.keys}

    def state(self) -> dict:
        return {"batch_st": self.batch_st, "data_idxs": self.data_idxs}
