"""The port's kernel launches in a traced window, and the least work each
needed (:mod:`benchmark.harness.roofline`).

:class:`Recorder` wraps the launchers of ``esrnerf_tpu_torch/ops/kernels.py``
while it is open: each launch records its kernel, its shapes, and references
to its row bases and ``n_valid`` (no copy, no launch of its own, so the trace
sees the program's launches alone). After the window :meth:`Recorder.work`
reads them and counts the distinct table rows each launch touched.
"""

from __future__ import annotations

import inspect
from typing import Dict, List

from benchmark.harness import roofline


class Recorder:
    def __init__(self):
        self.records: List[dict] = []
        self._orig: Dict[str, object] = {}

    def __enter__(self):
        from esrnerf_tpu_torch.ops import kernels

        self._mod = kernels
        for name in roofline.KERNELS:
            f = getattr(kernels, name)
            self._orig[name] = f
            setattr(kernels, name, self._wrap(name, f))
        return self

    def __exit__(self, *exc):
        for name, f in self._orig.items():
            setattr(self._mod, name, f)
        self._orig.clear()
        return False

    def _wrap(self, name, f):
        sig = inspect.signature(f)
        records = self.records

        def recording(*args, **kwargs):
            a = sig.bind(*args, **kwargs).arguments
            rec = {"kernel": name}
            if name.startswith("scan"):
                rec["N"], rec["S"] = (int(x) for x in a["alpha"].shape)
            else:
                rec["base"] = a["base"]
                rec["offsets"] = tuple(int(o) for o in a["offsets"])
                rec["n_valid"] = a.get("n_valid")
                if name == "splat":
                    rec["S"], rec["C"], rec["M"] = (int(x) for x in
                                                    a["vals"].shape)
                    rec["R"] = int(a["out"].shape[0])
                else:
                    rec["R"], rec["C"] = (int(x) for x in a["table"].shape)
                    rec["M"] = int(a["base"].shape[0])
                    rec["D"] = len(rec["offsets"])
            records.append(rec)
            return f(*args, **kwargs)

        return recording

    def work(self) -> List[dict]:
        """Per recorded launch ``{"kernel", "bytes", "flops", "bound_s"}``."""
        import torch

        out = []
        for r in self.records:
            k = r["kernel"]
            if k == "scan_fwd":
                w = roofline.scan_fwd(r["N"], r["S"])
            elif k == "scan_bwd":
                w = roofline.scan_bwd(r["N"], r["S"])
            else:
                nv = r["n_valid"]
                nv = None if nv is None else int(nv)
                mv = roofline.live_rows(
                    r["M"], nv, 1 if k == "splat" else roofline.GATHER_CHUNK)
                base = r["base"][:mv].long()
                offs = torch.tensor(r["offsets"], device=base.device)
                idx = (base[:, None] + offs[None, :]).reshape(-1)
                idx = idx[(idx >= 0) & (idx < r["R"])]
                rows = int(torch.unique(idx).numel())
                if k == "splat":
                    w = roofline.splat(r["S"], r["C"], mv, rows)
                elif k == "gather_weighted":
                    w = roofline.gather_weighted(r["C"], r["D"], r["M"], mv,
                                                 rows)
                else:
                    w = roofline.gather_raw(r["D"], r["M"], mv, rows)
            out.append({"kernel": k, **w, "bound_s": roofline.bound_s(w)})
        return out
