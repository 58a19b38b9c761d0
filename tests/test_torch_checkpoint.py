"""The port's durable checkpoints (``repro_torch.checkpoint``) and the
simulator's ``params`` setter against the JAX package's.

* The file format is the reference's, key for key: a checkpoint written
  by either package loads in the other (nested dicts, lists past ten
  items, ``None``, 0-d unicode, ``__meta__/``), tensors written as their
  numpy values.
* Durability as in ``tests/test_checkpoint.py``: atomic writes leave no
  ``.tmp`` orphan and keep the previous file when a write fails; a
  truncated file raises ``CheckpointError``, a missing one
  ``FileNotFoundError``; cadence discovery is numeric; GC keeps the newest
  k, tolerates racing deletes and leaves a restorable suffix when it dies
  mid-way.
* ``load_pytree(target=)`` matches leaves by key (not by the order of a
  flattening) and places each on its target tensor's device and dtype; a
  bf16 tensor has no numpy dtype and raises a ``TypeError`` on save.
* The modules of this slice import no JAX and nothing of ``repro``.
* ``HFLSimulator.params = stacked`` ravels like the reference's setter,
  into a fresh buffer, and a checkpointed simulator resumes its async run
  exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import load_pytree as j_load  # noqa: E402
from repro.checkpoint import save_pytree as j_save  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro.fl import sim as j_sim  # noqa: E402
from repro.models import lenet as j_lenet  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    gc_checkpoints, latest_checkpoint,
                                    list_checkpoints, load_pytree,
                                    save_pytree)
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.fl import sim as t_sim  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.models import lenet as t_lenet  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PROBLEM = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0,
               samples_lo=50, samples_hi=120)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(tensors: bool):
    """The reference test's nested tree, plus the key orders a flattening
    would get wrong: a list past ten items and keys around '/'."""
    rng = np.random.default_rng(0)
    leaf = ((lambda x: torch.as_tensor(x)) if tensors else (lambda x: x))
    return {
        "model": {"w": leaf(np.arange(12.0).reshape(3, 4)),
                  "b": leaf(np.zeros(4, np.float32)),
                  "frozen": None},
        "layers": [{"k": leaf(np.ones(2))}, {"k": leaf(np.full(2, 2.0))},
                   None],
        "seq": [leaf(rng.normal(size=3).astype(np.float32))
                for _ in range(12)],
        "a-b": leaf(np.int64(5)),
        "a": {"x": leaf(np.arange(3, dtype=np.int32))},
        "step": np.asarray(7, np.int64),
        "trace_json": np.str_('[{"kind": "merge"}]'),
    }


def _check_loaded(out, meta):
    assert out["model"]["frozen"] is None
    assert out["layers"][2] is None
    np.testing.assert_array_equal(out["model"]["w"],
                                  np.arange(12.0).reshape(3, 4))
    np.testing.assert_array_equal(out["layers"][1]["k"], [2.0, 2.0])
    assert len(out["seq"]) == 12
    np.testing.assert_array_equal(out["seq"][11],
                                  _tree(False)["seq"][11])
    assert int(out["a-b"]) == 5 and int(out["step"]) == 7
    assert out["a"]["x"].dtype == np.int32
    assert str(out["trace_json"]) == '[{"kind": "merge"}]'
    assert int(meta["round"]) == 3 and str(meta["tag"]) == "svc"


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_files_cross_between_packages(tmp_path, writer, reader):
    save = save_pytree if writer == "torch" else j_save
    load = load_pytree if reader == "torch" else j_load
    path = save(str(tmp_path / "ck"), _tree(writer == "torch"),
                metadata={"round": 3, "tag": "svc"})
    out, meta = load(path)
    _check_loaded(out, meta)


def test_port_file_is_the_reference_file_key_for_key(tmp_path):
    tp = save_pytree(str(tmp_path / "t"), _tree(True), metadata={"s": 2})
    jp = j_save(str(tmp_path / "j"), _tree(False), metadata={"s": 2})
    tz, jz = np.load(tp), np.load(jp)
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        assert tz[k].dtype == jz[k].dtype, k
        np.testing.assert_array_equal(tz[k], jz[k])


def test_save_is_atomic_no_tmp_orphan(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_pytree(path, {"x": torch.ones(3)})
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    save_pytree(path, {"x": torch.full((3,), 9.0)})
    out, _ = load_pytree(path)
    np.testing.assert_array_equal(out["x"], [9.0, 9.0, 9.0])
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]


def test_failed_write_keeps_previous_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    save_pytree(path, {"x": np.arange(4.0)})

    def dying(f, **kw):
        f.write(b"half a zip")
        raise KeyboardInterrupt("crash mid-save")

    monkeypatch.setattr(np, "savez", dying)
    with pytest.raises(KeyboardInterrupt):
        save_pytree(path, {"x": np.zeros(4)})
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    out, _ = load_pytree(path)
    np.testing.assert_array_equal(out["x"], np.arange(4.0))


def test_load_missing_vs_corrupted(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_pytree(str(tmp_path / "nope.npz"))
    path = save_pytree(str(tmp_path / "ck"), {"x": np.arange(1000.0)})
    blob = open(path, "rb").read()
    for cut in (10, len(blob) // 2, len(blob) - 8):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(CheckpointError, match="corrupted or truncated"):
            load_pytree(path)
    with open(path, "wb") as f:
        f.write(b"not a zip archive at all")
    with pytest.raises(CheckpointError):
        load_pytree(path)


def test_cadence_discovery_numeric_order(tmp_path):
    d = str(tmp_path)
    assert list_checkpoints(d) == [] and latest_checkpoint(d) is None
    for n in (1, 2, 10):
        save_pytree(os.path.join(d, f"ckpt-{n}"), {"n": np.asarray(n)})
    save_pytree(os.path.join(d, "other-3"), {"n": np.asarray(0)})
    open(os.path.join(d, "ckpt-4.npz.tmp"), "wb").close()
    names = [os.path.basename(p) for p in list_checkpoints(d)]
    assert names == ["ckpt-1.npz", "ckpt-2.npz", "ckpt-10.npz"]
    assert os.path.basename(latest_checkpoint(d)) == "ckpt-10.npz"
    assert [os.path.basename(p) for p in
            list_checkpoints(d, prefix="other-")] == ["other-3.npz"]
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def _seed_ckpts(d, ns):
    for n in ns:
        save_pytree(os.path.join(d, f"ckpt-{n}"), {"n": np.asarray(n)})


def test_gc_keeps_newest_k_and_validates_k(tmp_path):
    d = str(tmp_path)
    _seed_ckpts(d, (1, 2, 3, 10, 11))
    deleted = gc_checkpoints(d, 2)
    assert [os.path.basename(p) for p in deleted] == \
        ["ckpt-1.npz", "ckpt-2.npz", "ckpt-3.npz"]
    assert [os.path.basename(p) for p in list_checkpoints(d)] == \
        ["ckpt-10.npz", "ckpt-11.npz"]
    assert gc_checkpoints(d, 2) == []
    assert gc_checkpoints(d, 5) == []
    with pytest.raises(ValueError, match="keep_last_k"):
        gc_checkpoints(d, 0)


def test_gc_tolerates_racing_deletes(tmp_path, monkeypatch):
    d = str(tmp_path)
    _seed_ckpts(d, (1, 2, 3))
    real_remove = os.remove

    def flaky(path):
        real_remove(path)
        if path.endswith("ckpt-1.npz"):
            raise FileNotFoundError(path)

    monkeypatch.setattr(os, "remove", flaky)
    deleted = gc_checkpoints(d, 1)
    assert [os.path.basename(p) for p in deleted] == ["ckpt-2.npz"]
    assert [os.path.basename(p) for p in list_checkpoints(d)] == \
        ["ckpt-3.npz"]


@pytest.mark.parametrize("crash_after", [0, 1, 2])
def test_crash_mid_gc_leaves_restorable_suffix(tmp_path, monkeypatch,
                                               crash_after):
    gens = (1, 2, 3, 4, 5)
    d = str(tmp_path)
    _seed_ckpts(d, gens)
    real_remove = os.remove
    calls = {"n": 0}

    def dying(path):
        if calls["n"] >= crash_after:
            raise KeyboardInterrupt("SIGKILL stand-in mid-GC")
        calls["n"] += 1
        real_remove(path)

    monkeypatch.setattr(os, "remove", dying)
    with pytest.raises(KeyboardInterrupt):
        gc_checkpoints(d, 2)
    monkeypatch.undo()
    left = [os.path.basename(p) for p in list_checkpoints(d)]
    assert left == [f"ckpt-{n}.npz" for n in gens[crash_after:]]
    tree, _ = load_pytree(latest_checkpoint(d))
    assert int(tree["n"]) == 5


def test_load_onto_target_matches_by_key_device_and_dtype(tmp_path):
    tree = _tree(True)
    tree["model"]["w"] = tree["model"]["w"].to(torch.float32)
    path = save_pytree(str(tmp_path / "ck"), _tree(False))
    out, _ = load_pytree(path, target=tree)
    assert out["model"]["frozen"] is None and out["layers"][2] is None
    assert out["model"]["w"].dtype == torch.float32
    assert out["model"]["b"].device == torch.device("cpu")
    for i in range(12):      # "seq[10]" sorts before "seq[2]" as a string
        torch.testing.assert_close(out["seq"][i], tree["seq"][i],
                                   rtol=0, atol=0)
    assert int(out["a-b"]) == 5 and out["a"]["x"].dtype == torch.int32
    assert isinstance(out["step"], np.ndarray)       # non-tensor target
    with pytest.raises(ValueError, match="keys do not match"):
        load_pytree(path, target={"model": tree["model"]})


def test_bf16_has_no_numpy_dtype(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        save_pytree(str(tmp_path / "ck"),
                    {"x": torch.ones(2, dtype=torch.bfloat16)})
    assert list(os.listdir(tmp_path)) == []


# ---------------------------------------------------------------------------
# The simulator's params setter and a checkpointed resume
# ---------------------------------------------------------------------------


def _loss_t(p, b):
    return t_lenet.logreg_loss(p, b, l2=1e-3)


@pytest.fixture(scope="module")
def logreg():
    jsch, tsch = j_plan(JProblem(**PROBLEM)), t_plan(TProblem(**PROBLEM))
    train = synthetic.logreg_data(seed=0, n=800, dim=12, num_classes=4)
    test = synthetic.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(0), 800,
                                     tsch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    return jsch, tsch, ue_data, test


def _tsim(setup, **kw):
    _, tsch, ue_data, _ = setup
    return t_sim.HFLSimulator(tsch, _loss_t,
                              t_lenet.logreg_init(12, 4, device="cpu"),
                              ue_data, lr=0.02, device="cpu", **kw)


def test_params_setter_matches_reference(logreg):
    jsch, _, ue_data, _ = logreg
    jsim = j_sim.HFLSimulator(
        jsch, lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3),
        j_lenet.logreg_init(jax.random.PRNGKey(0), 12, 4), ue_data, lr=0.02)
    tsim = _tsim(logreg)
    rng = np.random.default_rng(3)
    stacked = {"w": rng.normal(size=(8, 12, 4)).astype(np.float32),
               "b": rng.normal(size=(8, 4)).astype(np.float32)}
    jsim.params = stacked
    tsim.params = stacked
    np.testing.assert_array_equal(tsim.flat_state(), jsim.flat_state())
    for got, want in zip(tree_leaves(tsim.params),
                         jax.tree.leaves(jsim.params)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a fresh buffer: writing the params given leaves the simulator alone
    src = {k: torch.as_tensor(v) for k, v in stacked.items()}
    tsim.params = src
    src["w"].zero_()
    assert float(tsim.params["w"].abs().sum()) > 0
    with pytest.raises(ValueError):
        tsim.params = {"w": stacked["w"][:4], "b": stacked["b"][:4]}


def test_checkpointed_simulator_resumes_exactly(logreg, tmp_path):
    """Async run split in two: the second half on the original simulator
    and on a fresh one restored from ``{"flat", "params"}`` through
    ``load_pytree(target=)`` and the setter give the same clock and
    params, bit for bit."""
    _, _, _, test = logreg
    sim = _tsim(logreg, mode="async", max_staleness=2)
    sim.run(test, rounds=2)
    path = save_pytree(str(tmp_path / "sim"),
                       {"flat": sim.flat_state(), "params": sim.params})
    fresh = _tsim(logreg, mode="async", max_staleness=2)
    tree, _ = load_pytree(path, target={"flat": fresh.flat_state(),
                                        "params": fresh.params})
    fresh.params = tree["params"]
    np.testing.assert_array_equal(fresh.flat_state(), tree["flat"])
    a, b = sim.run(test, rounds=2), fresh.run(test, rounds=2)
    np.testing.assert_array_equal(a.times, b.times)
    np.testing.assert_array_equal(a.test_loss, b.test_loss)
    for x, y in zip(tree_leaves(a.final_params),
                    tree_leaves(b.final_params)):
        assert float((x - y).abs().max()) == 0.0


@pytest.mark.cuda
def test_load_onto_card_target(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = save_pytree(str(tmp_path / "ck"),
                       {"x": torch.arange(6.0).reshape(2, 3)})
    out, _ = load_pytree(path, target={"x": torch.zeros(2, 3,
                                                        device="cuda")})
    assert out["x"].device.type == "cuda"
    torch.testing.assert_close(out["x"].cpu(),
                               torch.arange(6.0).reshape(2, 3))


def test_slice_modules_import_no_jax():
    code = ("import sys; import repro_torch.launch.service, "
            "repro_torch.checkpoint, repro_torch.core.jointopt, "
            "repro_torch.core.schedule; bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr
