"""Convert a reference (ecrireme/ESR-NeRF, PyTorch) checkpoint into the
port's checkpoint format.

Usage:
  python -m esrnerf_tpu_torch.scripts.import_reference_ckpt <ref.ckpt> <out.ckpt> [kind]

``kind`` is one of dvgo | voxurfc | voxurff | esrnerf; when omitted it is
inferred from the checkpoint's path (the reference names run directories
by stage class, e.g. ``.../fine.Fine/...``). The optimizer state is not
carried over: import a finished stage's last.ckpt and warm-start the next
stage, which starts its own optimizer. Runs on the CPU; the reference's
pickled config loads without its packages (``omegaconf``) installed.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
    from esrnerf_tpu_torch.utils.import_torch_ckpt import (
        KINDS, convert_checkpoint, infer_kind, load_reference)

    src, dst = argv[0], argv[1]
    kind = argv[2] if len(argv) > 2 else infer_kind(src)
    if kind not in KINDS:
        print(f"cannot infer the model kind from the path ({kind!r}); pass "
              f"one of {'|'.join(KINDS)} explicitly")
        return 2
    payload = convert_checkpoint(load_reference(src), kind)
    ckpt_io.save_checkpoint(dst, payload)
    print(f"imported kind={kind}: {sorted(payload['renderer']['params'])} "
          f"-> {dst} (global_step={payload['trainer']['global_step']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
