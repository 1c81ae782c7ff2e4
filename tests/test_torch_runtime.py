"""The port's checkpoints, fault-tolerant driver, straggler monitor,
elastic mesh planner and training launcher on the CPU, against the JAX
package where it has the same function.

* Checkpoints cross between the packages bit for bit, both ways, bf16
  leaves and the optimizer state's int32 step included.
* The driver recovers from an injected fault by restoring the latest
  checkpoint, gives up after ``max_restarts``, and a resumed training
  run equals the uninterrupted one exactly (``torch.equal``).
* The straggler monitor and ``plan_elastic_mesh`` give the reference's
  answers on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.runtime import StragglerMonitor as JStragglerMonitor
from repro.runtime import plan_elastic_mesh as jplan
from repro_torch import configs
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.data import SyntheticPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (DriverConfig, StragglerMonitor,
                                 TrainDriver, plan_elastic_mesh)
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.tree import tree_items, tree_leaves


def _port_tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(3, 4, generator=g),
            "b": {"w": torch.randn(2, 5, generator=g).bfloat16(),
                  "s": torch.tensor(3, dtype=torch.int32)},
            "opt": {"mu": {"a": torch.randn(3, 4, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _bits(x):
    """An array's bits as an integer array (bf16 through its view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy().astype(np.int64)
        return x.numpy().view(f"u{x.element_size()}").astype(np.int64)
    a = np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}").astype(np.int64)


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    t = _port_tree()
    save_checkpoint(tmp_path, 5, t)
    like = {"a": jnp.zeros((3, 4)), "b": {"w": jnp.zeros((2, 5)),
                                          "s": jnp.zeros(())},
            "opt": {"mu": {"a": jnp.zeros((3, 4))}, "step": jnp.zeros(())}}
    got, step = jrestore(tmp_path, like)
    assert step == 5
    want = dict(tree_items(t))
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = tuple(str(p.key) for p in path)
        assert str(leaf.dtype) == str(want[key].dtype).split(".")[1]
        np.testing.assert_array_equal(_bits(leaf), _bits(want[key]))


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    rng = np.random.default_rng(1)
    t = {"a": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32),
         "b": {"w": jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16),
               "s": jnp.asarray(3, jnp.int32)}}
    jsave(tmp_path, 9, t)
    like = {"a": torch.zeros(3, 4), "b": {"w": torch.zeros(2, 5),
                                          "s": torch.zeros(())}}
    got, step = restore_checkpoint(tmp_path, like)
    assert step == 9
    assert got["b"]["w"].dtype == torch.bfloat16
    assert got["b"]["s"].dtype == torch.int32
    for (path, leaf), want in zip(tree_items(got), jax.tree.leaves(t)):
        np.testing.assert_array_equal(_bits(leaf), _bits(want),
                                      err_msg="/".join(path))


def test_latest_marker_and_gc(tmp_path):
    t = _port_tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, t, keep=2)
    assert latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_000000004", "step_000000005"]
    assert not list(tmp_path.glob(".tmp_*"))


def test_restore_missing_leaf_raises(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="'b'"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(3),
                                      "b": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", {"a": torch.zeros(3)})


# ---------------------------------------------------------------- driver
def _toy_step(params, opt, batch):
    p = {"w": params["w"] - 0.1 * batch["g"]}
    return p, opt, {"loss": torch.sum(p["w"] ** 2)}


def test_driver_recovers_from_injected_fault(tmp_path):
    faults = {12}

    def fault_hook(step):
        if step in faults:
            faults.discard(step)              # fail once
            raise RuntimeError("injected device loss")

    drv = TrainDriver(
        DriverConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5,
                     max_restarts=2),
        _toy_step, lambda s: {"g": torch.tensor(float(s % 3))},
        fault_hook=fault_hook)
    p, _ = drv.run({"w": torch.ones(4)}, {})
    restarts = [e for e in drv.events if e.kind == "restart"]
    assert [e.step for e in restarts] == [12]
    assert latest_step(tmp_path) == 20
    # resumed from step 10's checkpoint: the same end as no fault
    want = torch.ones(4) - 0.1 * sum(float(s % 3) for s in range(20))
    torch.testing.assert_close(p["w"], want)


def test_driver_gives_up_after_max_restarts(tmp_path):
    def always_fail(step):
        raise RuntimeError("permafault")
    drv = TrainDriver(
        DriverConfig(total_steps=5, ckpt_dir=str(tmp_path),
                     max_restarts=2),
        _toy_step, lambda s: {"g": torch.tensor(0.0)},
        fault_hook=always_fail)
    with pytest.raises(RuntimeError, match="max_restarts"):
        drv.run({"w": torch.ones(2)}, {})
    assert sum(e.kind == "restart" for e in drv.events) == 3


def test_resumed_training_equals_the_uninterrupted_run(tmp_path):
    """qwen3-smoke in bf16: 6 steps, checkpoints every 3, a fault at
    step 4; the run that restored step 3 ends with every parameter and
    optimizer leaf equal to the run without the fault."""
    cfg = configs.get_smoke("qwen3-0.6b")
    model = DecoderLM(cfg, device="cpu")
    opt = OptConfig(lr=1e-3, warmup_steps=2)
    pipe = SyntheticPipeline(cfg, batch=2, seq=16)
    ends = []
    for name, faults in (("clean", set()), ("fault", {4})):
        def hook(step, faults=faults):
            if step in faults:
                faults.discard(step)
                raise RuntimeError("injected")
        params = model.init(seed=5)
        drv = TrainDriver(
            DriverConfig(total_steps=6, ckpt_dir=str(tmp_path / name),
                         ckpt_every=3, log_every=1),
            make_train_step(model, cfg, opt=opt),
            lambda s: pipe.device_batch(s, "cpu"), fault_hook=hook)
        p, o = drv.run(params, init_opt_state(params, opt))
        ends.append({"params": p, "opt": o})
        kinds = [e.kind for e in drv.events]
        assert kinds.count("restart") == (name == "fault")
    for (path, a), b in zip(tree_items(ends[0]), tree_leaves(ends[1])):
        assert torch.equal(a, b), "/".join(path)


# ------------------------------------------------------ straggler, mesh
def test_straggler_monitor_matches_reference():
    times = [1.0] * 10 + [5.0, 1.1, 0.9, 3.0, 1.0, 2.6, 1.0]
    port, ref = StragglerMonitor(threshold=2.0, warmup=3), \
        JStragglerMonitor(threshold=2.0, warmup=3)
    for i, t in enumerate(times):
        a, b = port.observe(i, t), ref.observe(i, t)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.step, a.step_time, a.ema, a.ratio) == (
                b.step, b.step_time, b.ema, b.ratio)
        assert port.ema == ref.ema
    assert len(port.events) == len(ref.events) > 0


@pytest.mark.parametrize("n,mp,pods,min_data", [
    (480, 16, 2, 1), (20, 16, 2, 1), (8, 16, 1, 1), (512, 8, 4, 2),
    (100, 4, 3, 10), (64, 64, 1, 1)])
def test_elastic_mesh_matches_reference(n, mp, pods, min_data):
    assert plan_elastic_mesh(n, model_parallel=mp, pods=pods,
                             min_data=min_data) == jplan(
        n, model_parallel=mp, pods=pods, min_data=min_data)


# -------------------------------------------------------------- launcher
def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    drv = launch_train.main(argv + ["--steps", "3"])
    assert [m["step"] for m in drv.metrics_log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
               for m in drv.metrics_log)
    assert latest_step(tmp_path) == 3
    drv = launch_train.main(argv + ["--steps", "4"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [m["step"] for m in drv.metrics_log] == [3]


def test_launcher_refuses_what_it_does_not_train(tmp_path):
    """The production mesh needs its 256 ranks: in a world of one the
    launcher refuses it instead of shrinking the mesh (every
    architecture trains since the families' slice)."""
    with pytest.raises(ValueError, match=r"\(16, 16\) needs 256 ranks"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                           "cpu", "--production-mesh", "--ckpt-dir",
                           str(tmp_path)])
