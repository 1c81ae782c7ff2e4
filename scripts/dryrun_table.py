"""Run the port's dry run over every cell in parallel processes, and
print its cells as the markdown table of PERF.md section 5.

    python scripts/dryrun_table.py run --out DIR --mesh both --jobs 8 \\
        [-- --rules sp | --variant opt]
    python scripts/dryrun_table.py table DIR [--mesh single] \\
        [--shape train_4k] [--against DIR2]

``run`` starts one ``python -m repro_torch.launch.dryrun --arch A
--shape S --mesh M --out DIR`` (with the arguments after ``--``) a cell
and mesh of ``configs.cells()``'s non-skipped cells, at most ``--jobs``
at a time, the slowest traces first (rwkv6's, then qwen1.5-110b's
``train_4k``); it exits 1 if any cell failed.  ``table`` prints one row
a cell JSON of DIR on ``--mesh`` (of ``--shape`` only, if given): GB a
device, whether it fits, the roofline's bottleneck and step time, the
FLOPs a device (``loop_aware.flops``, TFLOP) and the collective bytes
of each of the five kinds (GB; a kind a JSON lacks reads 0); with
``--against`` each number that differs is followed by DIR2's for the
same cell in parentheses.  DIR2 may be the JAX package's own output
directory as its dry run writes it (``python -m repro.launch.dryrun
--arch A --shape S`` writes ``results/dryrun/A__S__single.json``, the
same names and keys), which puts the port beside the reference; its
``fits`` is against the reference's own device, and its step time from
the reference's own hardware constants.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _cells():
    from repro_torch import configs
    return [(a, s.name) for a, s, skip in configs.cells() if skip is None]


def _cost(cell) -> int:
    arch, shape = cell
    return (2 if arch == "rwkv6-3b" else
            1 if (arch, shape) == ("qwen1.5-110b", "train_4k") else 0)


def run(out: Path, meshes, jobs: int, extra) -> int:
    out.mkdir(parents=True, exist_ok=True)
    todo = [(a, s, m) for a, s in sorted(_cells(), key=_cost, reverse=True)
            for m in meshes]

    def one(cell):
        arch, shape, mesh = cell
        t0 = time.time()
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out),
             *extra], capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        print(f"{arch} {shape} {mesh} rc={done.returncode} "
              f"{time.time() - t0:.0f}s {done.stdout.strip()}", flush=True)
        return done.returncode
    with ThreadPoolExecutor(jobs) as pool:
        rcs = list(pool.map(one, todo))
    return int(any(rcs))


def _row(res) -> list:
    mem, roof = res["memory"], res["roofline"]
    coll = res["loop_aware"]["collective_bytes"]
    return [mem["per_device_bytes"] / 1e9, "yes" if mem["fits"] else "no",
            roof["bottleneck"], roof["step_time_s"],
            res["loop_aware"]["flops"] / 1e12,
            *(coll.get(k, 0.0) / 1e9 for k in KINDS)]


def _fmt(v) -> str:
    if isinstance(v, str):
        return v
    return f"{v:.4g}" if abs(v) < 100 else f"{v:.1f}"


def table(path: Path, mesh: str, against, only=None) -> None:
    cols = ["GB / device", "fits", "bottleneck", "step_time_s", "TFLOP",
            *(f"{k} GB" for k in KINDS)]
    print("| arch | shape | " + " | ".join(cols) + " |")
    print("|---" * (len(cols) + 2) + "|")
    for arch, shape in _cells():
        if only is not None and shape != only:
            continue
        name = f"{arch}__{shape}__{mesh}.json"
        f = path / name
        if not f.exists():
            print(f"| {arch} | {shape} | " + " | ".join(["missing"] *
                                                       len(cols)) + " |")
            continue
        row = _row(json.loads(f.read_text()))
        if against is not None and (against / name).exists():
            base = _row(json.loads((against / name).read_text()))
            cells = [_fmt(a) if a == b else f"{_fmt(a)} ({_fmt(b)})"
                     for a, b in zip(row, base)]
        else:
            cells = [_fmt(v) for v in row]
        print(f"| {arch} | {shape} | " + " | ".join(cells) + " |")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--out", required=True)
    r.add_argument("--mesh", default="both",
                   choices=["single", "multi", "both"])
    r.add_argument("--jobs", type=int, default=8)
    t = sub.add_parser("table")
    t.add_argument("dir")
    t.add_argument("--mesh", default="single")
    t.add_argument("--shape", default=None)
    t.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        meshes = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
        return run(Path(args.out), meshes, args.jobs, extra)
    table(Path(args.dir), args.mesh,
          None if args.against is None else Path(args.against), args.shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
