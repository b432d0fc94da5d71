"""Ray batch sampler; the port's copy of ``BatchSampler`` from
``esrnerf_tpu/data/sampler.py`` (on numpy arrays).

An epoch-free shuffled batcher over the preloaded ray pool, checkpointable
via ``(batch_st, data_idxs)``. Shuffling uses an explicit
``np.random.Generator`` seeded like the JAX package's, so both give the
same batches for a seed. The pool lives in host memory; ``sample()``
returns numpy slices that the trainer copies to the device. Rows are
gathered with ``np.take`` and ``np.compress``: the same rows as fancy
indexing, several times faster on the tens of millions of rays of a DTU
scan. ``sample()`` runs in the span ``data/sample``, a reshuffle in
``data/shuffle``. Also the port's copy of ``RayGroupManager``, the
two-pool sampler of the LTS and PDRA stages.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from esrnerf_tpu_torch.utils import profiling


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
        self.data = {k: np.take(data[k], self.data_idxs, axis=0)
                     for k in keys}

    @property
    def data_num(self) -> int:
        return len(self.data_idxs)

    def shuffle(self) -> None:
        with profiling.span("data/shuffle"):
            order = self.rng.permutation(self.data_num)
            self.data_idxs = self.data_idxs[order]
            for k in self.keys:
                self.data[k] = np.take(self.data[k], order, axis=0)
            self.batch_st = 0

    def filter(self, mask: np.ndarray) -> None:
        mask = np.asarray(mask, dtype=bool)
        for k in self.keys:
            self.data[k] = np.compress(mask, self.data[k], axis=0)
        self.data_idxs = self.data_idxs[mask]

    def sample(self) -> Dict[str, np.ndarray]:
        with profiling.span("data/sample"):
            b_en = self.batch_st + self.batch_size
            if b_en > self.data_num:
                self.shuffle()
                b_en = self.batch_size
            b_st = self.batch_st
            self.batch_st = b_en
            return {k: self.data[k][b_st:b_en] for k in self.keys}

    def state(self) -> dict:
        return {"batch_st": self.batch_st, "data_idxs": self.data_idxs}


class RayGroupManager:
    """Two-pool sampler: rays start *uncertain* and monotonically move to the
    *certain* pool via ``filter(keep_uncertain_mask)``
    (reference ``utils2/utils.py:122-313``)."""

    def __init__(
        self,
        cfg,
        data: Dict[str, np.ndarray],
        keys: List[str],
        uncert_batch_size: int,
        cert_batch_size: int,
        uncert_batch_st: int = 0,
        cert_batch_st: int = 0,
        uncert_data_idxs: Optional[np.ndarray] = None,
        cert_data_idxs: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.keys = keys
        self.uncert_batch_size = uncert_batch_size
        self.cert_batch_size = cert_batch_size
        self.uncert_batch_st = uncert_batch_st
        self.cert_batch_st = cert_batch_st
        self.rng = np.random.default_rng(seed)

        self.uncert_data_idxs = (
            np.arange(len(data[keys[0]]))
            if uncert_data_idxs is None
            else np.asarray(uncert_data_idxs)
        )
        self.cert_data_idxs = (
            np.arange(0) if cert_data_idxs is None else np.asarray(cert_data_idxs)
        )
        self.uncert_data = {
            k: np.take(data[k], self.uncert_data_idxs, axis=0) for k in keys
        }
        self.cert_data = {
            k: np.take(data[k], self.cert_data_idxs, axis=0) for k in keys
        }

    @property
    def uncert_data_num(self) -> int:
        return len(self.uncert_data_idxs)

    @property
    def cert_data_num(self) -> int:
        return len(self.cert_data_idxs)

    def shuffle_uncert(self) -> None:
        with profiling.span("data/shuffle"):
            order = self.rng.permutation(self.uncert_data_num)
            self.uncert_data_idxs = self.uncert_data_idxs[order]
            for k in self.keys:
                self.uncert_data[k] = np.take(self.uncert_data[k], order,
                                               axis=0)
            self.uncert_batch_st = 0

    def shuffle_cert(self) -> None:
        with profiling.span("data/shuffle"):
            order = self.rng.permutation(self.cert_data_num)
            self.cert_data_idxs = self.cert_data_idxs[order]
            for k in self.keys:
                self.cert_data[k] = np.take(self.cert_data[k], order,
                                               axis=0)
            self.cert_batch_st = 0

    def shuffle(self) -> None:
        self.shuffle_uncert()
        self.shuffle_cert()

    def filter(self, mask: np.ndarray) -> None:
        """mask True = stays uncertain; False rays move to the certain pool."""
        mask = np.asarray(mask, dtype=bool)
        nmask = ~mask
        for k in self.keys:
            self.cert_data[k] = np.ascontiguousarray(
                np.concatenate([self.cert_data[k], self.uncert_data[k][nmask]], 0)
            )
            self.uncert_data[k] = np.compress(mask, self.uncert_data[k],
                                              axis=0)
        self.cert_data_idxs = np.concatenate(
            [self.cert_data_idxs, self.uncert_data_idxs[nmask]], 0
        )
        self.uncert_data_idxs = self.uncert_data_idxs[mask]

    def sample(self) -> Dict[str, np.ndarray]:
        with profiling.span("data/sample"):
            return self._sample()

    def _sample(self) -> Dict[str, np.ndarray]:
        u_en = self.uncert_batch_st + self.uncert_batch_size
        c_en = self.cert_batch_st + self.cert_batch_size
        if u_en > self.uncert_data_num:
            self.shuffle_uncert()
            u_en = min(self.uncert_data_num, self.uncert_batch_size)
        if c_en > self.cert_data_num:
            self.shuffle_cert()
            c_en = min(self.cert_data_num, self.cert_batch_size)

        u_st, c_st = self.uncert_batch_st, self.cert_batch_st
        self.uncert_batch_st, self.cert_batch_st = u_en, c_en
        u_bs, c_bs = u_en - u_st, c_en - c_st

        def take(data, st, en, want):
            """Slice [st:en], wrap-around-filling to ``want`` rows when the
            pool is smaller than the batch size — keeps the jitted train
            step's shapes static (the reference shrinks the batch instead,
            utils2/utils.py:269-303, which would force recompilation)."""
            n = len(data[self.keys[0]])
            out = {k: data[k][st:en] for k in self.keys}
            have = en - st
            if n > 0 and have < want:
                extra = self.rng.integers(0, n, want - have)
                out = {k: np.concatenate([out[k], data[k][extra]], 0)
                       for k in self.keys}
            return out

        u = take(self.uncert_data, u_st, u_en, self.uncert_batch_size)
        c = take(self.cert_data, c_st, c_en, self.cert_batch_size)
        u_n = len(u[self.keys[0]])
        c_n = len(c[self.keys[0]])
        um = np.concatenate(
            [np.ones(u_n, bool), np.zeros(c_n, bool)]
        )

        # An EMPTY pool can't wrap-fill its own block — borrow rows from the
        # other pool, flagged with the borrowed pool's mask value, so the
        # batch is (uncert_bs + cert_bs) rows from step 0. The reference
        # emits a shrunken batch until the first regroup
        # (utils2/utils.py:269-303); at production shapes that is one extra
        # full train-step compile mid-run (minutes on this backend).
        def borrow(dst, n_dst, want, src, src_n, flag):
            pad_n = want - n_dst
            if pad_n <= 0 or src_n == 0:
                return dst, np.array([], bool)
            extra = self.rng.integers(0, src_n, pad_n)
            dst = {k: np.concatenate([dst[k], src[k][extra]], 0)
                   for k in self.keys}
            return dst, np.full(pad_n, flag, bool)

        u, u_pad_m = borrow(u, u_n, self.uncert_batch_size,
                            self.cert_data, self.cert_data_num, False)
        c, c_pad_m = borrow(c, c_n, self.cert_batch_size,
                            self.uncert_data, self.uncert_data_num, True)
        batch = {
            k: np.concatenate([u[k], c[k]], 0) for k in self.keys
        }
        batch["uncert_masks"] = np.concatenate(
            [um[:u_n], u_pad_m, um[u_n:], c_pad_m]
        )
        return batch

    def state(self) -> dict:
        return {
            "uncert_batch_st": self.uncert_batch_st,
            "cert_batch_st": self.cert_batch_st,
            "uncert_data_idxs": self.uncert_data_idxs,
            "cert_data_idxs": self.cert_data_idxs,
        }
