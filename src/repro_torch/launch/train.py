"""Training launcher of the port: the reference's
``repro.launch.train`` on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --batch 8 --seq 256 --ckpt-dir "$(mktemp -d)"

Trains from a seeded random init on ``SyntheticPipeline`` data through
``TrainDriver``: a checkpoint every ``--ckpt-every`` steps, a restart
from ``LATEST`` (also when the launcher is run again on the same
directory), straggler events logged.  Runs on the GPU; ``--device cpu``
(with ``--smoke``) runs the plain PyTorch versions of the kernels on
the CPU instead:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 3 --batch 2 --seq 32 --ckpt-dir "$CKPT"

(run again on the same ``$CKPT`` with more ``--steps`` to resume).

Every ``--arch`` of ``configs.ARCH_NAMES`` trains: the dense stacks,
the MoEs (deepseek-moe, llama4-scout) and the lockstep-only families
(qwen2-vl, whisper, recurrentgemma, rwkv6), for example

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --smoke --device cpu --steps 3 --batch 2 --seq 32 --ckpt-dir "$CKPT"

**On a mesh.**  Under ``torchrun`` (one process a rank) it trains on
the local mesh ``(world, 1)`` over ``("data", "model")``: FSDP over
``data``, each rank on ``cuda:{LOCAL_RANK}`` over NCCL, or with
``--device cpu`` on the CPU over gloo:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-0.6b --smoke --device cpu --steps 3 --batch 8 \
        --seq 32 --ckpt-dir "$CKPT"

``--production-mesh`` builds the reference's ``(16, 16)`` mesh, and
refuses a world of any other size.  Parameters, optimizer state and
batches are the rank's shards; checkpoints hold full arrays, so a run
resumes on any mesh.  Without ``torchrun`` the run is the
single-device one.  ``main`` returns the driver (its ``metrics_log`` and
``events``).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch.distributed as dist

from .. import configs
from ..checkpoint import latest_step, restore_checkpoint
from ..data import SyntheticPipeline
from ..models import build_model
from ..runtime import DriverConfig, TrainDriver
from ..sharding import tree_shardings
from ..sharding.spmd import shard_tree
from ..train.optimizer import OptConfig, init_opt_state, opt_state_specs
from ..train.step import make_train_step
from .mesh import make_local_mesh, make_production_mesh

__all__ = ["main"]


def main(argv=None) -> TrainDriver:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between entries of the metrics log")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
    mesh = _mesh(args)
    device = args.device if mesh is None else mesh.device
    model = build_model(cfg, device=device)
    opt = OptConfig(lr=args.lr)
    step_fn = make_train_step(model, cfg, opt=opt, n_micro=args.n_micro)
    params = model.init(seed=0)
    shardings = None
    if mesh is not None:
        shardings = {"params": tree_shardings(model.param_specs(), mesh),
                     "opt": tree_shardings(
                         opt_state_specs(model.param_specs(), opt), mesh)}
        params = shard_tree(params, shardings["params"], mesh)
    opt_state = init_opt_state(params, opt)
    start = 0
    with mesh if mesh is not None else contextlib.nullcontext():
        if latest_step(args.ckpt_dir) is not None:
            tree, start = restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt_state},
                shardings=shardings)
            params, opt_state = tree["params"], tree["opt"]
            _say(mesh, f"resumed from step {start}")

        pipe = SyntheticPipeline(cfg, batch=args.batch, seq=args.seq)
        driver = TrainDriver(
            DriverConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every),
            step_fn, lambda s: pipe.device_batch(s, model.device, mesh),
            shardings=shardings)
        driver.run(params, opt_state, start_step=start)
    for m in driver.metrics_log:
        _say(mesh, f"step {m['step']:5d}  loss {m['loss']:.4f}  "
             f"{m['wall_s'] * 1e3:.0f} ms")
    _say(mesh, f"done: {args.steps} steps; events: "
         f"{[(e.kind, e.step) for e in driver.events][-5:]}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return driver


def _say(mesh, line: str) -> None:
    """Print on one rank (every rank logs the same whole-batch loss)."""
    if mesh is None or mesh.rank == 0:
        print(line)


def _mesh(args):
    """The local mesh ``(world, 1)`` under torchrun (``--device cpu``:
    every rank on the CPU), the production mesh with
    ``--production-mesh``, else None (one device)."""
    if args.production_mesh:
        return make_production_mesh(devices=_devices(args))
    if "TORCHELASTIC_RUN_ID" in os.environ or "LOCAL_RANK" in os.environ:
        return make_local_mesh(devices=_devices(args))
    return None


def _devices(args):
    if args.device is None:
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return [args.device] * world


if __name__ == "__main__":
    main()
