"""Rank bodies of ``tests/test_torch_mesh.py``.

Each job runs in every process of a gloo group on the CPU
(``torch.multiprocessing``), imports nothing of JAX, and saves what the
test holds against the reference to ``<tmp>/<job>_<rank>.pt``.  The
rendezvous is a ``FileStore`` in the test's own directory, so parallel
test workers never share a port.
"""
import contextlib
import hashlib
import math
import struct

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._pytree import tree_flatten

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.gemm_dataflow import ops as gemm
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import build_model
from repro_torch.models import components as C
from repro_torch.sharding import collectives, spmd, tree_shardings
from repro_torch.sharding.rules import (DEFAULT_RULES, SP_RULES,
                                        set_active_rules)
from repro_torch.sharding.spmd import shard_tree, unshard_tree
from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                         opt_state_specs)
from repro_torch.train.step import make_grad_fn, make_train_step
from repro_torch.tree import tree_items

AXES = ("data", "model")


def spawn(job, shape, tmp, payload) -> list:
    """Run ``job`` on every rank of a ``shape`` mesh; returns each
    rank's saved result, rank order."""
    world = math.prod(shape)
    mp.spawn(_entry, args=(world, tuple(shape), job, str(tmp), payload),
             nprocs=world, join=True)
    return [torch.load(f"{tmp}/{job}_{r}.pt") for r in range(world)]


def _warm() -> None:
    """The first call of each transcendental function, made before any
    value is used (``test_torch_model.warm_torch_threads``)."""
    x = torch.linspace(-4.0, 4.0, 1 << 16)
    for fn in (torch.exp, torch.log1p, torch.tanh, torch.sin, torch.cos,
               torch.sigmoid):
        fn(x)


def _entry(rank, world, shape, job, tmp, payload) -> None:
    torch.set_num_threads(1)
    _warm()
    init_distributed("gloo", rank=rank, world_size=world,
                     init_method=f"file://{tmp}/store_{job}", timeout_s=300)
    mesh = make_mesh(shape, AXES, devices=["cpu"] * world)
    out = JOBS[job](mesh, tmp, payload)
    torch.save(out, f"{tmp}/{job}_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _sharded(model, mesh, full):
    sh = tree_shardings(model.param_specs(), mesh)
    return shard_tree(full, sh, mesh), sh


@contextlib.contextmanager
def _rules(rules):
    """Run under ``rules`` as the active rules (the default restored)."""
    set_active_rules(rules)
    try:
        yield
    finally:
        set_active_rules(DEFAULT_RULES)


def _grads(mesh, model, cfg, params, sh, batch, n_micro, rules):
    """(loss, every leaf's whole gradient, the collectives' tally) of
    the grad step under ``rules``."""
    collectives.reset_stats()
    with _rules(rules), mesh:
        loss, _, grads = make_grad_fn(model, cfg, n_micro=n_micro)(
            params, batch)
        tally = collectives.stats()
        return (float(loss), [mesh.unshard(g, spec) for g, spec in
                              zip(grads, _specs(sh))], tally)


def train_case(mesh, case) -> dict:
    """The gradient of step 0 under the default rules and under
    ``SP_RULES`` (sequence parallelism) and ``steps`` train steps of one
    model on the mesh; the whole arrays (gathered), and the checkpoint
    of the last state when ``case`` names a directory."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    params, sh = _sharded(model, mesh, torch.load(case["params"]))
    pipe = SyntheticPipeline(cfg, case["B"], case["S"])
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    out = {"losses": []}
    batch = pipe.device_batch(0, mesh=mesh)
    out["grad_loss"], out["grads"], _ = _grads(
        mesh, model, cfg, params, sh, batch, case["n_micro"], DEFAULT_RULES)
    out["sp_loss"], out["sp_grads"], _ = _grads(
        mesh, model, cfg, params, sh, batch, case["n_micro"], SP_RULES)
    with mesh:
        state = init_opt_state(params, opt)
        step = make_train_step(model, cfg, opt=opt, n_micro=case["n_micro"])
        for s in range(case["steps"]):
            params, state, m = step(params, state,
                                    pipe.device_batch(s, mesh=mesh))
            out["losses"].append(float(m["loss"]))
        out["params"] = unshard_tree(params, sh, mesh)
        if case.get("ckpt"):
            shardings = {"params": sh, "opt": tree_shardings(
                opt_state_specs(model.param_specs(), opt), mesh)}
            tree = {"params": params, "opt": state}
            save_checkpoint(case["ckpt"], case["steps"], tree,
                            shardings=shardings)
            out["saved"] = unshard_tree(tree, shardings, mesh)
    return out


def _specs(tree) -> list:
    """The leaves of a tree (``logical_spec`` tuples or tensors) in
    ``tree_leaves`` order."""
    return [leaf for _, leaf in tree_items(tree)]


def moe_case(mesh, case) -> dict:
    """``components.moe_block`` expert-parallel over ``model`` on the
    rank's data rows of ``x``, its parameters stored as the mesh places
    them (experts over model, the embed dim over data)."""
    cfg = case["cfg"]
    place = spmd.placements(C.moe_specs(cfg), mesh)
    stored = shard_tree(case["p"], {k: _spec_tree(v) for k, v in
                                    place.items()}, mesh)
    tp = spmd.TP(mesh, experts=spmd.splits(place["wg"][0], 0),
                 shared=spmd.splits(place["shared"]["wg"][0], 1))
    x = case["x"]
    n = x.shape[0] // mesh.axis_size("data")
    xs = x[mesh.axis_index("data") * n:][:n]
    with mesh, torch.no_grad():
        y, aux = C.moe_block(spmd.localize(stored, place, tp), xs, cfg, tp)
    return {"y": y, "aux": float(aux), "tp": (tp.experts, tp.shared)}


def cross_kv_case(mesh, case) -> dict:
    """``components.encode_cross_kv`` with the heads split over ``model``
    but not the KV heads: this rank's K/V, and the gradients of a loss
    of them (the cotangents of its heads) into the whole ``wk`` / ``wv``
    (this rank's share: the columns of the KV heads it read) and into
    the encoder output (summed over ``model``)."""
    cfg = case["cfg"]
    m, r = mesh.axis_size(spmd.MODEL), mesh.axis_index(spmd.MODEL)
    tp = spmd.TP(mesh, head_range=spmd.rank_heads(cfg.n_heads, m, r),
                 n_heads=cfg.n_heads)
    w = {k: case[k].clone().requires_grad_() for k in ("wk", "wv")}
    enc = case["enc"].clone().requires_grad_()
    h = cfg.n_heads // tp.size
    with mesh:
        k, v = C.encode_cross_kv(w, enc, cfg, tp)
        loss = sum((t * case[g].narrow(2, tp.index * h, h)).sum()
                   for t, g in ((k, "gk"), (v, "gv")))
        loss.backward()
    return {"k": k.detach(), "v": v.detach(), "wk": w["wk"].grad,
            "wv": w["wv"].grad, "enc": enc.grad}


def _spec_tree(place):
    if isinstance(place, dict):
        return {k: _spec_tree(v) for k, v in place.items()}
    return place[0]


def decode_case(mesh, case) -> dict:
    """A whole cache from the unsharded prefill cut for the mesh
    (``shard_cache``), and a prefill on the mesh, each followed by
    decode steps; the rank's rows of each step's logits, and the shapes
    of the made cache's leaves beside the shards ``cache_specs`` places
    (a leaf that is not a tensor, as ``pos``, left out)."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    full = torch.load(case["params"])
    params, _ = _sharded(model, mesh, full)
    batch = case["batch"]
    n = batch["tokens"].shape[0] // mesh.axis_size("data")
    d = mesh.axis_index("data")
    mine = {k: t[d * n:][:n] for k, t in batch.items()}
    with torch.no_grad():
        _, whole = model.prefill(full, batch, max_len=case["max_len"])
    specs = model.cache_specs(batch["tokens"].shape[0], case["max_len"])
    out = {}
    with mesh, torch.no_grad():
        cut = model.shard_cache(whole, mesh)
        _, made = model.prefill(params, mine, max_len=case["max_len"])
        out["seq_shards"] = (cut["seq_shards"], made["seq_shards"])
        out["shapes"] = [got[1:] for got in spmd.shard_shapes(
            made, specs, tree_shardings(specs, mesh), mesh)]
        for name, cache in (("cut", cut), ("made", made)):
            steps = []
            for t in case["feed"]:
                lg, cache = model.decode_step(params, cache,
                                              t[d * n:][:n, None])
                steps.append(lg)
            out[name] = torch.stack(steps)
    return out


def model_logits(mesh, case) -> torch.Tensor:
    """The whole model's logits on the rank's data rows (``apply`` on
    the mesh)."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    params, _ = _sharded(model, mesh, torch.load(case["params"]))
    batch = SyntheticPipeline(cfg, case["B"], case["S"]).device_batch(
        0, mesh=mesh)
    with mesh, torch.no_grad():
        return model.apply(params, batch)


def sp_prefill(mesh, case) -> dict:
    """A prefill on the mesh under the default rules and under
    ``SP_RULES``: whether the logits and every cache leaf (this rank's
    shards) are ``torch.equal``."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    params, _ = _sharded(model, mesh, torch.load(case["params"]))
    batch = case["batch"]
    n = batch["tokens"].shape[0] // mesh.axis_size("data")
    mine = {k: t[mesh.axis_index("data") * n:][:n] for k, t in batch.items()}
    got = []
    for rules in (DEFAULT_RULES, SP_RULES):
        with _rules(rules), mesh, torch.no_grad():
            got.append(model.prefill(params, mine, max_len=case["max_len"]))
    (l0, c0), (l1, c1) = got
    leaves = [(a, b) for a, b in zip(tree_flatten(c0)[0],
                                     tree_flatten(c1)[0])
              if isinstance(a, torch.Tensor)]
    return {"logits": torch.equal(l0, l1), "leaves": len(leaves),
            "cache": all(torch.equal(a, b) for a, b in leaves)}


def sp_indivisible(mesh, case) -> dict:
    """The grad step at a sequence length ``model`` does not divide,
    under the default rules and under ``SP_RULES``: whether the loss,
    every gradient and the collectives' tally are equal."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    params, sh = _sharded(model, mesh, torch.load(case["params"]))
    batch = SyntheticPipeline(cfg, case["B"], case["S"]).device_batch(
        0, mesh=mesh)
    a, b = (_grads(mesh, model, cfg, params, sh, batch, 1, rules)
            for rules in (DEFAULT_RULES, SP_RULES))
    return {"loss": a[0] == b[0], "tally": a[2] == b[2],
            "grads": all(torch.equal(x, y) for x, y in zip(a[1], b[1]))}


def even_cut(mesh, case) -> dict:
    """The grad step of an even split under the default rules, as it
    runs and with ``TP.cut`` forced on every split attention (its
    leaves gathered over ``model`` and cut to the rank's heads, as an
    uneven split takes them): whether the loss and every gradient are
    ``torch.equal``."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    params, sh = _sharded(model, mesh, torch.load(case["params"]))
    batch = SyntheticPipeline(cfg, case["B"], case["S"]).device_batch(
        0, mesh=mesh)
    got = [_grads(mesh, model, cfg, params, sh, batch, case["n_micro"],
                  DEFAULT_RULES)]
    cut = spmd.TP.cut
    spmd.TP.cut = property(lambda tp: tp.heads)
    try:
        got.append(_grads(mesh, model, cfg, params, sh, batch,
                          case["n_micro"], DEFAULT_RULES))
    finally:
        spmd.TP.cut = cut
    (la, ga, _), (lb, gb, _) = got
    return {"loss": la == lb, "leaves": len(ga),
            "grads": all(torch.equal(a, b) for a, b in zip(ga, gb)),
            "digest": digest(la, ga)}


def digest(loss, grads) -> str:
    """The first 16 hex digits of the SHA-256 of the loss (an f64) and
    every gradient's bytes in order: equal digests, equal bits."""
    h = hashlib.sha256(struct.pack("<d", loss))
    for g in grads:
        h.update(g.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def call_log(mesh, case) -> dict:
    """Every collective of the grad step, in order, by the axes of its
    group: {axes: [(kind, input shape), ...]}; and the query heads of
    this rank's first layer."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    params, sh = _sharded(model, mesh, torch.load(case["params"]))
    batch = SyntheticPipeline(cfg, case["B"], case["S"]).device_batch(
        0, mesh=mesh)
    calls, last, tally, group = {}, [], collectives._tally, mesh.group

    def grouped(axes):
        last[:] = [tuple(a for a in AXES if a in axes)]
        return group(axes)

    def log(kind, t, seconds):
        calls.setdefault(last[0], []).append((kind, tuple(t.shape)))
        tally(kind, t, seconds)
    collectives._tally, mesh.group = log, grouped
    try:
        _grads(mesh, model, cfg, params, sh, batch, case["n_micro"],
               DEFAULT_RULES)
    finally:
        collectives._tally = tally
        del mesh.group
    pl = spmd.unstack(model.placement(mesh)["layers"])
    tp = model._tp(mesh, "attn", pl, False)
    return {"calls": calls, "heads": len(tp.head_range)}


def tally_case(mesh, case) -> dict:
    """The collectives' tally of the grad step under the default rules
    and under ``SP_RULES``, seeded parameters in the config's own
    dtypes (the dry run's kernels take bf16)."""
    cfg = case["cfg"]
    model = build_model(cfg, device="cpu")
    params, sh = _sharded(model, mesh, model.init(seed=0))
    batch = SyntheticPipeline(cfg, case["B"], case["S"]).device_batch(
        0, mesh=mesh)
    return {name: _grads(mesh, model, cfg, params, sh, batch, 1, rules)[2]
            for name, rules in (("default", DEFAULT_RULES),
                                ("sp", SP_RULES))}


def mesh22(mesh, tmp, payload) -> dict:
    """Everything the (2, 2) group checks, in one spawn."""
    out = {name: train_case(mesh, case)
           for name, case in payload["train"].items()}
    out["sp_vl"] = train_case(mesh, payload["sp_vl"])
    out["sp_prefill"] = {name: sp_prefill(mesh, case) for name, case in
                         payload["sp_prefill"].items()}
    out["sp_indivisible"] = sp_indivisible(mesh, payload["sp_indivisible"])
    out["tally"] = tally_case(mesh, payload["tally"])
    out["even_cut"] = {name: even_cut(mesh, case) for name, case in
                       payload["even_cut"].items()}
    out["call_log"] = call_log(mesh, payload["call_log"])
    out["ep"] = moe_case(mesh, payload["ep"])
    out["cross_kv"] = cross_kv_case(mesh, payload["cross_kv"])
    out["ep_model"] = model_logits(mesh, payload["ep_model"])
    out["decode"] = decode_case(mesh, payload["decode"])
    out["family_decode"] = {name: decode_case(mesh, case) for name, case
                            in payload["family_decode"].items()}
    return out if mesh.rank == 0 else {
        k: v for k, v in out.items()
        if k in ("ep", "ep_model", "decode", "family_decode", "sp_prefill",
                 "sp_indivisible", "cross_kv", "even_cut", "call_log")}


def restore(mesh, tmp, payload) -> dict:
    """The (2, 2) run's checkpoint restored onto this mesh, gathered."""
    cfg = payload["cfg"]
    model = build_model(cfg, device="cpu")
    params, sh = _sharded(model, mesh, torch.load(payload["params"]))
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    shardings = {"params": sh, "opt": tree_shardings(
        opt_state_specs(model.param_specs(), opt), mesh)}
    like = {"params": params, "opt": init_opt_state(params, opt)}
    with mesh:
        tree, step = restore_checkpoint(payload["ckpt"], like,
                                        shardings=shardings)
        full = unshard_tree(tree, shardings, mesh)
    return {"step": step, "full": full,
            "shard_shapes": [t.shape for t in _specs(tree)]}


def lora(mesh, tmp, payload) -> dict:
    """The default rules' grad step of each case (rwkv6's time mix):
    the loss, every leaf's whole gradient and the shapes (a, b) of each
    f32 product ``project`` the step made on this rank (its decay
    LoRA's), in ``components`` and in ``LinearFn``."""
    out = {}
    for name, case in payload.items():
        cfg = case["cfg"]
        model = build_model(cfg, device="cpu")
        params, sh = _sharded(model, mesh, case["params"])
        batch = SyntheticPipeline(cfg, case["B"], case["S"]).device_batch(
            0, mesh=mesh)
        seen, project = [], C.project

        def spy(a, b):
            if a.dtype == torch.float32:
                seen.append((tuple(a.shape), tuple(b.shape)))
            return project(a, b)
        C.project = gemm.project = spy
        try:
            loss, grads, _ = _grads(mesh, model, cfg, params, sh, batch, 1,
                                    DEFAULT_RULES)
        finally:
            C.project = gemm.project = project
        out[name] = {"loss": loss, "grads": grads, "f32": seen}
    return out


JOBS = {"mesh22": mesh22, "restore": restore, "lora": lora}
