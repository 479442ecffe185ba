"""Checkpoints, fault tolerance and the training launcher of the port
(``checkpoint/``, ``runtime/``, ``launch/train.py``, the ``train_driver``
twin), on the CPU: the counterparts of ``tests/test_checkpoint_ft.py``
(atomic commit, async writes, crash-resume, heartbeats, elastic re-mesh,
the launcher end to end), and

* a ``TrainState`` the reference saves restores in the port into equal
  arrays (and one the port saves restores in the reference): the leaf
  names are ``jax.tree_util.tree_flatten_with_path``'s;
* an ``AsyncCheckpointer`` snapshot is not changed by a later in-place
  optimizer step;
* the launcher's resumed losses equal an uninterrupted run's bit for bit
  (the port on the CPU is deterministic);
* the ``train_driver`` twin crashes and resumes on the CPU.
"""
import json
import os

import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.launch import steps as j_steps
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               _flatten_with_names, cleanup,
                                               latest_step, restore, save)
from repro_torch.convert import train_state_from_numpy
from repro_torch.examples import train_driver
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as tl
from repro_torch.nn.params import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault_tolerance import (HeartbeatTable, StepGuard,
                                                 elastic_mesh_shape,
                                                 rebalance_batch)
from test_torch_support import (arch_twin_cfgs, numpy_arch_params,
                                one_torch_thread)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SMOKE = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2", "--seq", "16",
         "--device", "cpu"]


def _leaves(tree):
    return _flatten_with_names(tree)[1]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((4, 8), generator=g),
        "b": torch.randn((8,), generator=g).bfloat16(),
        "step": torch.tensor(3, dtype=torch.int32),
        "nested": {"m": torch.randn((2, 2), generator=g)},
    }


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_save_restore_roundtrip_exact(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t)
    back = restore(str(tmp_path), 7, _zeros_like(t))
    for a, b in zip(tree_leaves(t), tree_leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_uncommitted_checkpoint_ignored(tmp_path):
    save(str(tmp_path), 5, _tree())
    save(str(tmp_path), 10, _tree())
    # simulate a host dying mid-save at step 10: directory, no COMMITTED
    os.remove(os.path.join(str(tmp_path), "step_000000010", "COMMITTED"))
    assert latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), 10, _tree())
    cleanup(str(tmp_path), keep=3)
    assert not os.path.exists(os.path.join(str(tmp_path), "step_000000010"))
    assert latest_step(str(tmp_path)) == 5


def test_cleanup_keeps_newest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, _tree())
    cleanup(str(tmp_path), keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert restore(str(tmp_path), 4, _tree()) is not None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), 3, _tree())


def test_async_checkpointer_durable_after_wait(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    ck.save(12, t)
    ck.wait()
    assert latest_step(str(tmp_path)) == 12 and ck.saved_steps == [12]
    back = restore(str(tmp_path), 12, _zeros_like(t))
    assert torch.equal(back["w"], t["w"])


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                              # reported once


def test_async_snapshot_is_not_changed_by_a_later_in_place_step(tmp_path):
    """save() copies now: the optimizer's in-place update right after it
    (on the CPU a tensor's numpy array would alias it) leaves the written
    checkpoint at the saved state."""
    jc, jd, _, _ = arch_twin_cfgs("dense")
    _, tp = numpy_arch_params(jc, jd, "bf16")
    opt = AdamW(lr=1e-2)
    state = t_steps.TrainState(tp, opt.init(tp))
    before = [x.clone() for x in _leaves(state)]
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    opt.update(tree_map(torch.ones_like, tp), state.opt, state.params)
    assert not torch.equal(_leaves(state)[0], before[0])    # in place
    ck.wait()
    back = restore(str(tmp_path), 1, state)
    for got, want in zip(_leaves(back), before):
        assert torch.equal(got, want)


def _ref_state():
    """A reference TrainState after one AdamW update (bf16 params, fp32
    moments and master, an int32 step), and the port's tree to restore
    into."""
    jc, jd, _, _ = arch_twin_cfgs("qkv_bias")
    jp, tp = numpy_arch_params(jc, jd, "bf16", seed=4)
    opt = JAdamW(lr=1e-2)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32), jp)
    params, ost, _ = jax.jit(opt.update)(grads, opt.init(jp), jp)
    like = t_steps.TrainState(tp, AdamW().init(tp))
    return j_steps.TrainState(params, ost), like


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, like = _ref_state()
    j_ckpt.save(str(tmp_path), 3, jstate)
    with open(tmp_path / "step_000000003" / "treedef.json") as f:
        names = json.load(f)["names"]
    assert names == _flatten_with_names(like)[0]
    assert ".opt/.step" in names and ".params/['final_norm']" in names
    back = restore(str(tmp_path), 3, like)
    carried = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert int(back.opt.step) == 1 and back.opt.step.dtype == torch.int32
    for got, conv, want in zip(_leaves(back), _leaves(carried),
                               jax.tree.leaves(jstate)):
        want = np.asarray(want.astype(jnp.float32) if want.dtype ==
                          jnp.bfloat16 else want)
        assert got.dtype == conv.dtype
        np.testing.assert_array_equal(got.float().numpy()
                                      if got.is_floating_point()
                                      else got.numpy(), want)
        assert torch.equal(got, conv)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, like = _ref_state()
    port = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    save(str(tmp_path), 9, port)
    back = j_ckpt.restore(str(tmp_path), 9, jstate)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_step_guard_crash_commits_then_resume(tmp_path):
    """The launcher's crash path: guard commits last-good state on failure,
    restart resumes from it and reaches the target step count."""
    def step_fn_factory(crash_at):
        def step_fn(state, batch):
            if crash_at is not None and int(state["n"]) + 1 == crash_at:
                raise RuntimeError("boom")
            return {"n": state["n"] + 1}, {"loss": torch.zeros(())}
        return step_fn

    def batches():
        while True:
            yield {}

    zero = {"n": torch.tensor(0, dtype=torch.int32)}
    guard = StepGuard(AsyncCheckpointer(str(tmp_path)), save_every=4)
    with pytest.raises(RuntimeError):
        guard.run(dict(zero), step_fn_factory(7), batches(), 20)
    last = latest_step(str(tmp_path))
    assert last == 6                       # crashed entering step 7
    state = restore(str(tmp_path), last, zero)
    assert int(state["n"]) == 6
    guard2 = StepGuard(AsyncCheckpointer(str(tmp_path)), save_every=4)
    state, end = guard2.run(state, step_fn_factory(None), batches(),
                            20 - last, start_step=last)
    assert int(state["n"]) == 20 and end == 20


def test_heartbeat_marks_dead_and_stays_dead():
    clock = {"t": 0.0}
    hb = HeartbeatTable(["a", "b", "c"], timeout_s=10.0,
                        clock=lambda: clock["t"])
    clock["t"] = 5.0
    hb.beat("a")
    hb.beat("b")
    clock["t"] = 12.0                      # c silent past the deadline
    assert hb.dead_hosts() == ["c"]
    assert hb.alive_hosts() == ["a", "b"]
    clock["t"] = 13.0
    hb.beat("c")                           # too late — dead stays dead
    assert hb.dead_hosts() == ["c"]


def test_elastic_remesh_after_pod_loss():
    """Losing a pod: 512 -> 256 chips keeps TP=16 and halves DP rows."""
    pods, data, model = elastic_mesh_shape(512, 16, pod_size=256)
    assert (pods, data, model) == (2, 16, 16)
    pods2, data2, model2 = elastic_mesh_shape(256, 16, pod_size=256)
    assert model2 == 16 and pods2 * data2 * model2 == 256
    assert rebalance_batch(256, old_data=pods * data,
                           new_data=pods2 * data2) == 128


def _losses(path):
    with open(path) as f:
        return {r["step"]: (r["loss"], r["grad_norm"])
                for r in map(json.loads, f)}


def test_train_launcher_crash_resume_e2e(tmp_path, monkeypatch, capsys):
    """The launcher (the train_driver example, compressed): it crashes
    entering step 6 with step 5 committed, resumes and runs --steps more
    (to 15, as the reference's does); the resumed losses equal an
    uninterrupted run's bit for bit."""
    ckpt = str(tmp_path / "ck")
    run = str(tmp_path / "resumed.jsonl")
    monkeypatch.setenv("REPRO_CRASH_AT_STEP", "6")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tl.main(SMOKE + ["--steps", "10", "--ckpt-dir", ckpt,
                         "--save-every", "2", "--log-every", "100",
                         "--metrics-out", run])
    monkeypatch.delenv("REPRO_CRASH_AT_STEP")
    assert latest_step(ckpt) == 5
    assert tl.main(SMOKE + ["--steps", "10", "--ckpt-dir", ckpt,
                            "--save-every", "5", "--log-every", "100",
                            "--metrics-out", run]) == 0
    out = capsys.readouterr().out
    assert f"[resume] restoring step 5 from {ckpt}" in out
    assert "[done] trained to step 15" in out
    assert latest_step(ckpt) == 15
    straight = str(tmp_path / "straight.jsonl")
    assert tl.main(SMOKE + ["--steps", "10", "--log-every", "100",
                            "--metrics-out", straight]) == 0
    got, want = _losses(run), _losses(straight)
    assert sorted(got) == list(range(1, 16)) and sorted(want) == \
        list(range(1, 11))
    for step in range(1, 11):
        assert got[step] == want[step], step


@pytest.mark.parametrize("flags,ranks", [
    (["--production-mesh"], 256), (["--production-mesh", "--multi-pod"], 512)])
def test_launcher_refuses_the_mesh_flags(flags, ranks):
    """In one process the production mesh exits naming the ranks it needs
    (the reference fails the same way, in ``jax.make_mesh``)."""
    with pytest.raises(SystemExit, match=f"needs {ranks} ranks"):
        tl.main(SMOKE + ["--steps", "1", *flags])


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_driver.main(["--steps", "1"])


def test_launcher_trains_an_embedding_front_end(capsys):
    """musicgen's stub front end: the pipeline's fp32 frames cast to the
    params' bf16."""
    assert tl.main(["--arch", "musicgen-large", "--smoke", "--steps", "2",
                    "--batch", "2", "--seq", "8", "--log-every", "1",
                    "--microbatch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step      2  loss" in out and "[done] trained to step 2" in out


def test_train_driver_twin_crashes_and_resumes(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.delenv("REPRO_CRASH_AT_STEP", raising=False)
    ckpt = str(tmp_path / "drv")
    argv = ["--arch", "qwen1.5-0.5b", "--steps", "4", "--batch", "2",
            "--seq", "8", "--ckpt-dir", ckpt, "--device", "cpu"]
    with pytest.raises(RuntimeError, match="simulated node failure at "
                       "step 3"):
        train_driver.main(argv + ["--crash-at", "3"])
    monkeypatch.delenv("REPRO_CRASH_AT_STEP")
    assert latest_step(ckpt) == 2
    assert train_driver.main(argv) == 0
    out = capsys.readouterr().out
    assert "[resume] restoring step 2" in out
    assert "[done] trained to step 6" in out
