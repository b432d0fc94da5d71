"""Entry point of the port: compose a config, set up logging, run a stage.

    python -m esrnerf_tpu_torch.run -cn cfg/exp/esrnerf/giftbox_w/fine.yaml \\
        app.phase=train [system.device=cpu] [key.path=value ...]

Mirrors the JAX package's ``run.py``: stage classes resolve by the same
dotted names (``app.cls``), the resolved config is saved into the log dir
with a copy of the port's package, and a training run resumes from
``<log.dir>/checkpoints/last.ckpt``. All five stages are ported
(``coarse.AlphaMask``, ``coarse.Coarse``, ``fine.Fine``, ``fine.LTS``,
``fine.PDRA``): with one ``log.root`` and ``log.name``, coarse finds
alphamask's ``last.ckpt``, fine finds coarse's, LTS finds fine's and PDRA
finds LTS's by path, so they chain without ``app.trainer.ckpt``. PDRA's
eval phases are ``test_nv`` and the relighting phases ``test_nvc``,
``test_nvi`` and ``test_nvic``. Both dataset families are ported
(``data.cls`` ``esrnerf.ESRNeRF`` and ``dtu.DTU``), so a DTU scan chains
the same way:

    for s in alphamask coarse fine lts; do
        python -m esrnerf_tpu_torch.run -cn cfg/exp/dtu/97/$s.yaml \
            app.phase=train data.root=<root> log.name=<run>
    done

where ``<root>`` holds ``dtu_scan97/`` and the Chamfer assets (``ObsMask/``,
``Points/stl/``; ``data.synthetic.write_dtu_scene`` writes such a scene);
coarse, fine and LTS then log ``mesh/CD`` with their evals.
``system.device=cpu`` runs on the CPU (the plain PyTorch versions of the
kernels); any other value, including the configs' ``tpu`` or none, means
the GPU, and the run raises when CUDA is not available.

Data-parallel over N ranks (one process each; NCCL with a card a rank,
gloo where ranks share a card or run on the CPU):

    torchrun --standalone --nproc_per_node=N -m esrnerf_tpu_torch.run \
        -cn cfg/exp/esrnerf/giftbox_w/fine.yaml app.phase=train \
        [system.parallel=gspmd [system.param_shard=fsdp]]

Every rank composes the config, then takes rank 0's (its ``log.name``
reads the clock), seeds alike and draws the same global batches; each
trains on its block of them (:mod:`esrnerf_tpu_torch.parallel.mesh`:
``shard_map`` by default, ``gspmd`` for world 1's step at any world,
``fsdp`` for grids and Adam moments kept as X-slabs). Rank 0 alone writes
the log dir.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

# stage-class dotted name -> implementing module/class in this package
STAGE_REGISTRY = {
    "coarse.AlphaMask": "esrnerf_tpu_torch.apps.alphamask.AlphaMask",
    "coarse.Coarse": "esrnerf_tpu_torch.apps.coarse.Coarse",
    "fine.Fine": "esrnerf_tpu_torch.apps.fine.Fine",
    "fine.LTS": "esrnerf_tpu_torch.apps.lts.LTS",
    "fine.PDRA": "esrnerf_tpu_torch.apps.pdra.PDRA",
}


def _snapshot_code(log_dir: str) -> None:
    """Copy the port's package and the config tree into the log dir, once
    per log dir (a resumed run keeps the first snapshot)."""
    dst = os.path.join(log_dir, "code")
    if os.path.exists(dst):
        return
    pkg = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(pkg)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "build", "*.so",
                                    "*.o")
    try:
        os.makedirs(dst)
        shutil.copytree(pkg, os.path.join(dst, "esrnerf_tpu_torch"),
                        ignore=ignore)
        if os.path.isdir(os.path.join(repo, "cfg")):
            shutil.copytree(os.path.join(repo, "cfg"),
                            os.path.join(dst, "cfg"), ignore=ignore)
    except OSError as e:  # a failed snapshot must not stop a training run
        print(f"code snapshot failed ({e!r}); continuing")


def main(argv=None):
    """Run one stage; returns the stage object (its ``timings``, with the
    datasets' load time ``data_s`` and the data and model set-up's
    ``setup_s``, and its model stay readable after the run)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-cn", "--config-name", required=True,
                        help="path to a composed YAML config")
    parser.add_argument("overrides", nargs="*",
                        help="dot-overrides like app.phase=train")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from esrnerf_tpu_torch.apps.base import import_class
    from esrnerf_tpu_torch.config import customize_cfg, load_cfg, save_cfg
    from esrnerf_tpu_torch.parallel.mesh import init_distributed
    from esrnerf_tpu_torch.utils.logging import seed_everything

    cfg = load_cfg(args.config_name, args.overrides)
    cls = cfg.app["cls"]
    cls_path = STAGE_REGISTRY.get(cls)
    if cls_path is None:
        raise KeyError(f"unknown app.cls '{cls}'")
    own_group = not dist.is_initialized()
    world = init_distributed(cfg)  # raises before any output without CUDA
    own_group = own_group and world.n > 1
    try:
        if world.n > 1:  # rank 0's config, before anything reads log.dir
            box = [cfg if world.is_writer else None]
            dist.broadcast_object_list(box, src=0)
            cfg = box[0]
        cfg = customize_cfg(cfg)
        if world.is_writer:
            os.makedirs(cfg.log["dir"], exist_ok=True)
            save_cfg(cfg)
            _snapshot_code(cfg.log["dir"])
        seed_everything(cfg.system["seed"])

        method = import_class(cls_path)(cfg)
        t0 = time.perf_counter()
        method.load_dataset()
        method.timings["data_s"] = time.perf_counter() - t0
        method.load_model()
        method.timings["setup_s"] = time.perf_counter() - t0
        method.process()
        if method.logger is not None:
            method.logger.finish()
    finally:
        if own_group:
            dist.destroy_process_group()
    return method


if __name__ == "__main__":
    main()
    sys.exit(0)
