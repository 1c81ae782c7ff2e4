"""Multi-pod dry run of the port: the reference's ``launch/dryrun.py``.

For every (arch x shape x mesh) cell it runs rank 0's program of the
port's own step function (``train/step.py:make_train_step``, the
model's ``prefill`` or ``decode_step``) on the production mesh, with
every tensor on ``meta``: shapes and dtypes flow, nothing is computed.
The mesh is a dry mesh (``launch/mesh.py:make_dry_mesh``), whose
collectives move no data and count the bytes NCCL would put on the
wire; the kernel wrappers take their shape-only branch and report the
work of the kernel they stand for; ``cost.py:OpCounter``
counts every other op.  It records, from an H100's datasheet numbers
(``cost.py:HW``):

* ``memory`` - rank 0's device bytes: ``argument_bytes`` (the
  parameter, optimizer-state, batch, cache and token shards handed to
  the step), ``output_bytes`` (what the step returns in storage of its
  own), ``alias_bytes`` (returned storage that is an argument's: a
  decode cache written in place), ``per_device_bytes`` (the traced peak
  of live device bytes) and ``temp_bytes`` = per_device - argument -
  output + alias, the reference's relation; ``fits`` against the card;
* ``loop_aware`` - flops, bytes, transcendentals and collective traffic
  by kind (``OpCost``; every layer and microbatch runs eagerly, so
  nothing is counted once for a loop);
* ``model_flops`` and ``roofline`` - the reference's formulas;
* ``kernels`` - each hand-written kernel's launches, flops and bytes;
* ``xla_cost_analysis`` - null: no compiler has a counterpart.

The dry run computes nothing, so it needs no GPU (``chip_smoke.py``'s
``dryrun`` phase holds its predictions against a real step on one).

``--rules sp`` traces under ``SP_RULES`` (the residual stream on
sequence shards over ``model``: Megatron's sequence parallelism,
``sharding/spmd.py``), and ``--variant opt`` each cell at the
reference's ``OPT_SETTINGS`` (config overrides and rules variant).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --all --mesh both --rules sp
    python -m repro_torch.launch.dryrun --all --mesh both --variant opt
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten

from .. import configs
from ..configs import shape_by_name
from ..data.specs import decode_token_specs, train_axes, train_specs
from ..models import build_model
from ..sharding import collectives, spmd
from ..sharding.rules import (DEFAULT_RULES, RULE_VARIANTS, active_rules,
                              logical_spec, set_active_rules,
                              tree_shardings)
from ..train.optimizer import OptConfig, init_opt_state
from ..train.step import auto_microbatches, make_grad_fn, make_train_step
from ..cost import HW, OpCounter
from .mesh import MULTI_POD_SHAPE, PRODUCTION_SHAPE, make_dry_mesh

__all__ = ["apply_overrides", "build_step", "collective_tally", "run_cell",
           "main", "dry_mesh_for", "memory_of", "model_flops", "trace"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def dry_mesh_for(mesh_kind: str):
    """Rank 0 of the reference's production mesh: (16, 16) over
    ("data", "model") for ``single``, (2, 16, 16) over ("pod", "data",
    "model") for ``multi``."""
    if mesh_kind == "multi":
        return make_dry_mesh(MULTI_POD_SHAPE, ("pod", "data", "model"))
    if mesh_kind == "single":
        return make_dry_mesh(PRODUCTION_SHAPE, ("data", "model"))
    raise ValueError(f"mesh must be single or multi, got {mesh_kind!r}")


def apply_overrides(cfg, overrides: dict):
    """dataclasses.replace with string-typed values from --set k=v."""
    typed = {}
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    for k, v in overrides.items():
        t = fields[k].type
        if t in ("int", int):
            typed[k] = int(v)
        elif t in ("float", float):
            typed[k] = float(v)
        elif t in ("bool", bool):
            typed[k] = v in ("1", "true", "True")
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def _full(spec) -> torch.Tensor:
    return torch.empty(tuple(spec.shape), dtype=spec.dtype, device="meta")


def _own(t):
    """A meta tensor of ``t``'s shape in storage of its own (a shard cut
    from a meta tensor is a view of the whole one's storage)."""
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _shards(spec_tree, mesh, rules):
    """Rank 0's meta shards of a spec tree (dicts and lists of
    ``ParamSpec``), placed by ``tree_shardings``; with no mesh the
    whole tensors."""
    full = _map(spec_tree, _full)
    if mesh is None:
        return full
    return _map(spmd.shard_tree(full, tree_shardings(spec_tree, mesh,
                                                      rules), mesh), _own)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _rows(spec, axes, mesh, rules) -> torch.Tensor:
    """Rank 0's meta piece of an input (``data/specs.py``)."""
    if mesh is None:
        return spec.meta()
    return _own(mesh.shard(spec.meta(), logical_spec(axes, spec.shape,
                                                     mesh, rules)))


def _batch(cfg, batch: int, seq: int, mesh, rules) -> dict:
    """Rank 0's meta rows of a training / prefill batch."""
    axes = train_axes(cfg, batch, seq)
    return {k: _rows(s, axes[k], mesh, rules)
            for k, s in train_specs(cfg, batch, seq).items()}


def _cache(model, batch: int, seq: int, mesh, rules) -> dict:
    """Rank 0's meta shard of a decode cache of capacity ``seq``, at
    position ``seq - 1`` (the last and most expensive step of the
    context), ``pos`` a CPU integer, as the model reads it on the
    host."""
    cache = _map(model.cache_specs(batch, seq), _full)
    if mesh is not None:
        cache = _map(model.shard_cache(cache, mesh), _own)
    cache["pos"] = torch.tensor(seq - 1, dtype=torch.int32)
    return cache


def build_step(arch: str, shape, mesh, rules=DEFAULT_RULES, cfg=None,
               n_micro: Optional[int] = None, grad: bool = False):
    """(step function, its arguments on meta, meta) of one cell on the
    dry mesh ``mesh`` (None: one device, no mesh): the train step at
    ``n_micro`` microbatches (default the reference's count,
    ``auto_microbatches`` at dp = pod x data; with ``grad`` its
    gradient alone, ``make_grad_fn``, no AdamW), the model's
    ``prefill`` or its ``decode_step``.  ``shape`` is a ``ShapeSpec``
    or the name of one of ``SHAPES``.  ``rules`` places the arguments;
    the activations follow the rules active when the step runs
    (``run_cell`` sets them)."""
    cfg = cfg or configs.get(arch)
    if isinstance(shape, str):
        shape = shape_by_name(shape)
    kw = {} if cfg.is_encoder_decoder else {"wkv_prefill": "chunked"}
    model = build_model(cfg, device="meta", **kw)
    params = _shards(model.param_specs(), mesh, rules)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind}
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        dp = 1 if mesh is None else mesh.axis_size(mesh.data_axes())
        n_micro = n_micro or auto_microbatches(cfg, B, S, dp)
        meta["n_micro"] = n_micro
        batch = _batch(cfg, B, S, mesh, rules)
        if grad:
            return make_grad_fn(model, cfg, n_micro=n_micro), (params,
                                                              batch), meta
        opt = OptConfig(keep_master=(cfg.param_dtype != "float32"))
        step = make_train_step(model, cfg, opt=opt, n_micro=n_micro)
        return step, (params, init_opt_state(params, opt), batch), meta
    if shape.kind == "prefill":
        return model.prefill, (params, _batch(cfg, B, S, mesh, rules)), meta
    tok, tok_axes = decode_token_specs(cfg, B)
    tokens = _rows(tok, tok_axes, mesh, rules)
    return model.decode_step, (params, _cache(model, B, S, mesh, rules),
                               tokens), meta


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_meta]


def _storages(tree) -> dict:
    """{id: bytes} of the meta storages a tree's tensors use."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def memory_of(args, out, peak: int) -> dict:
    """The reference's ``memory`` keys (module docstring) of a step
    that took ``args`` and returned ``out`` with ``peak`` live bytes at
    most."""
    a, o = _storages(args), _storages(out)
    arg = sum(a.values())
    alias = sum(n for k, n in o.items() if k in a)
    out_b = sum(o.values())
    return {"argument_bytes": arg, "output_bytes": out_b,
            "temp_bytes": peak - arg - out_b + alias,
            "alias_bytes": alias, "per_device_bytes": peak,
            "hbm_budget_bytes": HW.hbm_bytes,
            "fits": bool(peak <= HW.hbm_bytes)}


def trace(fn, args, mesh=None):
    """Run ``fn(*args)`` on ``mesh`` (None: one device) under an
    ``OpCounter`` with the arguments counted as live; returns (output,
    counter, seconds)."""
    counter = OpCounter()
    t0 = time.time()
    with mesh or contextlib.nullcontext(), counter:
        counter.track(_tensors(args))
        out = fn(*args)
    return out, counter, time.time() - t0


def collective_tally(cfg, shape, mesh, rules=DEFAULT_RULES,
                     n_micro: int = 1) -> dict:
    """``collectives.stats()`` of rank 0's grad step (``build_step``
    with ``grad``) of ``cfg`` at ``shape`` on the dry mesh ``mesh``,
    traced under ``rules`` with the arguments placed by the default
    rules, as a live step on a mesh places them (its batch cut before
    the rules are set): every collective's calls and the bytes of its
    input buffers, which a live rank's tally of the same step must
    equal, and (``wire_bytes``) the bytes it puts on the wire.  Resets
    the tally; the previous rules are restored after."""
    before = active_rules()
    collectives.reset_stats()
    try:
        fn, args, _ = build_step(cfg.name, shape, mesh, cfg=cfg,
                                 n_micro=n_micro, grad=True)
        set_active_rules(rules)
        _, counter, _ = trace(fn, args, mesh)
    finally:
        set_active_rules(before)
    tally = collectives.stats()
    for kind, rec in tally.items():
        rec["wire_bytes"] = counter.cost.coll_bytes[kind.replace("_", "-")]
    return tally


def model_flops(cfg, shape_name: str, world: int) -> dict:
    """The reference's model FLOPs of a cell: 6 (train) or 2 times the
    active parameters times the tokens (one a row for decode), and a
    device's share of ``world``."""
    shape = shape_by_name(shape_name)
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    return {"n_params": cfg.n_params(), "n_active_params": n_active,
            "global": flops, "per_device": flops / world}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             rules=DEFAULT_RULES, cfg=None, tag: str = "",
             mesh=None) -> dict:
    """One cell's JSON (the reference's keys; module docstring), traced
    under ``rules`` as the active rules (``set_active_rules``, as the
    reference's ``run_cell`` sets them; the previous rules restored
    after): ``SP_RULES`` lays the residual stream out on sequence shards
    over ``model``.  ``mesh``: a dry mesh in place of ``mesh_kind``'s
    production one."""
    mesh = mesh or dry_mesh_for(mesh_kind)
    world = mesh.size
    before = active_rules()
    set_active_rules(rules)
    try:
        fn, args, meta = build_step(arch, shape_name, mesh, rules, cfg=cfg)
        out, counter, t_trace = trace(fn, args, mesh)
    finally:
        set_active_rules(before)
    cost = counter.cost

    mf = model_flops(cfg or configs.get(arch), shape_name, world)
    model_flops_dev = mf["per_device"]

    t_compute = cost.flops / HW.peak_flops_bf16
    t_memory = cost.bytes / HW.hbm_bw
    t_coll = cost.coll_total / HW.ici_link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "world": world, **meta, "tag": tag,
        "lower_s": round(t_trace, 2), "compile_s": None,
        "memory": memory_of(args, out, counter.peak),
        "xla_cost_analysis": None,
        "loop_aware": {
            "flops": cost.flops,
            "bytes": cost.bytes,
            "transcendentals": cost.transcendentals,
            "collective_bytes": cost.coll_bytes,
            "collective_ops": cost.coll_ops,
            "collective_total_bytes": cost.coll_total,
        },
        "kernels": cost.kernels,
        "model_flops": {
            **mf, "useful_ratio": (model_flops_dev / cost.flops
                                   if cost.flops else 0.0),
        },
        "roofline": {
            **terms,
            "bottleneck": bottleneck.replace("_s", ""),
            "step_time_s": step_s,
            "roofline_fraction": t_compute / step_s if step_s > 0 else 0.0,
            "model_fraction": (model_flops_dev / HW.peak_flops_bf16
                               / step_s if step_s > 0 else 0.0),
        },
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="config override key=value (e.g. loss_chunk=512)")
    ap.add_argument("--rules", default="default",
                    help="sharding-rules variant (default | sp)")
    ap.add_argument("--variant", default=None,
                    help="'opt' applies configs.OPT_SETTINGS per arch")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs on a (2, 2) / (2, 2, 2) mesh "
                    "(a quick check of the whole table)")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.overrides)
    rules = RULE_VARIANTS[args.rules]

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    get = configs.get_smoke if args.smoke else configs.get

    if args.all:
        todo = [(a, s.name) for a, s, skip in configs.cells()
                if skip is None]
        skips = [(a, s.name, skip) for a, s, skip in configs.cells()
                 if skip is not None]
        (out / "skips.json").write_text(json.dumps(
            [{"arch": a, "shape": s, "reason": r} for a, s, r in skips],
            indent=2))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in todo:
        for mesh_kind in meshes:
            name = f"{arch}__{shape}__{mesh_kind}"
            if args.tag != "baseline":
                name += f"__{args.tag}"
            path = out / f"{name}.json"
            if args.skip_existing and path.exists():
                print(f"[skip] {name}")
                continue
            try:
                cell_over, cell_rules = dict(overrides), rules
                if args.variant == "opt":
                    ov, rv = configs.opt_settings_for(arch, shape)
                    cell_over = {**ov, **cell_over}
                    cell_rules = RULE_VARIANTS[rv]
                cfg = apply_overrides(get(arch), cell_over)
                mesh = None
                if args.smoke:
                    mesh = make_dry_mesh(
                        (2, 2, 2) if mesh_kind == "multi" else (2, 2),
                        ("pod", "data", "model") if mesh_kind == "multi"
                        else ("data", "model"))
                res = run_cell(arch, shape, mesh_kind, tag=args.tag,
                               cfg=cfg, rules=cell_rules, mesh=mesh)
                path.write_text(json.dumps(res, indent=2))
                r = res["roofline"]
                m = res["memory"]
                print(f"[ok] {name}: bottleneck={r['bottleneck']} "
                      f"step={r['step_time_s']:.4f}s "
                      f"frac={r['model_fraction']:.3f} "
                      f"mem={m['per_device_bytes'] / 1e9:.2f}GB "
                      f"fits={m['fits']} trace={res['lower_s']:.0f}s",
                      flush=True)
            except Exception as e:
                failures += 1
                print(f"[FAIL] {name}: {type(e).__name__}: {e}",
                      flush=True)
                (out / f"{name}.error.txt").write_text(
                    traceback.format_exc())
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
