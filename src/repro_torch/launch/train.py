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

``--production-mesh`` raises ``NotImplementedError`` (the training mesh
is not ported: ROADMAP Queue 1 item 14b).  ``main`` returns the driver (its
``metrics_log`` and ``events``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from .. import configs
from ..checkpoint import latest_step, restore_checkpoint
from ..data import SyntheticPipeline
from ..models import build_model
from ..runtime import DriverConfig, TrainDriver
from ..train.optimizer import OptConfig, init_opt_state
from ..train.step import make_train_step

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
    if args.production_mesh:
        raise NotImplementedError("--production-mesh: the port has no "
                                  "training mesh yet (ROADMAP Queue 1 "
                                  "item 14b)")

    cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
    model = build_model(cfg, device=args.device)
    step_fn = make_train_step(model, cfg, opt=OptConfig(lr=args.lr),
                              n_micro=args.n_micro)
    params = model.init(seed=0)
    opt_state = init_opt_state(params)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        tree, start = restore_checkpoint(
            args.ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = tree["params"], tree["opt"]
        print(f"resumed from step {start}")

    pipe = SyntheticPipeline(cfg, batch=args.batch, seq=args.seq)
    driver = TrainDriver(
        DriverConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, log_every=args.log_every),
        step_fn, lambda s: pipe.device_batch(s, model.device))
    driver.run(params, opt_state, start_step=start)
    for m in driver.metrics_log:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"{m['wall_s'] * 1e3:.0f} ms")
    print(f"done: {args.steps} steps; events: "
          f"{[(e.kind, e.step) for e in driver.events][-5:]}")
    return driver


if __name__ == "__main__":
    main()
