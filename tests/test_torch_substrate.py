"""The port's optimizer, gradient compression, data pipeline and
checkpoints against the JAX package's, on the CPU: the twins of
``tests/test_substrate.py`` (``TestOptim``, ``TestData``,
``TestCheckpoint`` with ``device=`` in place of ``shardings=``, and the
restart supervisor over the port's ``CheckpointManager``), then parity on
the same numpy inputs: AdamW and the schedule within the f32 bounds stated
at each test, the int8 round trip and ``SyntheticLM`` bit for bit, and
checkpoint directories that cross-restore between the two packages.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.checkpoint import manager as cm  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM  # noqa: E402
from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: E402
                                     adamw_update, cosine_schedule,
                                     global_norm_clip)
from repro_torch.optim.compression import (compress_decompress,  # noqa: E402
                                           compression_init, quantize)
from repro_torch.runtime.fault_tolerance import RestartSupervisor  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

CPU = "cpu"
U32 = 2.0 ** -24   # f32 unit roundoff


class TestOptim:
    def test_adamw_minimizes_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        st = adamw_init(params)
        target = torch.tensor([1.0, 2.0])
        for _ in range(200):
            g = {"w": 2 * (params["w"] - target)}
            params, st, _ = adamw_update(g, st, 0.05, weight_decay=0.0,
                                         param_dtype=torch.float32)
        assert torch.allclose(params["w"], target, atol=0.05)

    def test_grad_clip(self):
        g = {"a": torch.full((10,), 100.0)}
        clipped, gn = global_norm_clip(g, 1.0)
        got = float(torch.sqrt(torch.sum(torch.square(clipped["a"]))))
        assert np.isclose(got, 1.0, rtol=1e-5) and float(gn) > 100

    def test_cosine_schedule(self):
        lr0 = cosine_schedule(torch.tensor(0, dtype=torch.int32),
                              peak_lr=1.0, warmup=10, total=100)
        lrp = cosine_schedule(torch.tensor(10), peak_lr=1.0, warmup=10,
                              total=100)
        lre = cosine_schedule(torch.tensor(100), peak_lr=1.0, warmup=10,
                              total=100)
        assert float(lr0) == 0.0 and np.isclose(float(lrp), 1.0)
        assert np.isclose(float(lre), 0.1, atol=1e-3)

    def test_compression_error_feedback(self):
        """Quantized-with-EF gradient sums converge to the true sum."""
        g = {"w": torch.tensor(np.random.RandomState(0).randn(256) * 1e-3)}
        ef = compression_init(g)
        acc = np.zeros(256)
        for _ in range(50):
            dq, ef = compress_decompress(g, ef)
            acc += dq["w"].double().numpy()
        true = 50 * g["w"].numpy()
        assert np.abs(acc - true).max() < 1e-4

    def test_compression_is_int8_representable(self):
        g = {"w": torch.tensor(np.random.RandomState(1).randn(64))}
        dq, _ = compress_decompress(g, compression_init(g))
        w = dq["w"].double().numpy()
        scale = np.abs(g["w"].numpy()).max() / 127.0
        ints = w / scale
        assert np.allclose(ints, np.round(ints), atol=1e-4)


class TestData:
    def test_deterministic_restart(self):
        src = SyntheticLM(vocab=100, batch=2, seq=8, seed=7)
        a, b = src.batch_at(13), src.batch_at(13)
        assert np.array_equal(a["tokens"], b["tokens"])

    def test_labels_are_next_tokens(self):
        src = SyntheticLM(vocab=100, batch=1, seq=8, seed=0)
        b = src.batch_at(0)
        assert b["tokens"].shape == (1, 8) and b["labels"].shape == (1, 8)

    def test_prefetch_pipeline_order_and_close(self):
        src = SyntheticLM(vocab=50, batch=1, seq=4, seed=0)
        pipe = PrefetchPipeline(src, start_step=5, device=CPU)
        steps = [next(pipe)[0] for _ in range(4)]
        pipe.close()
        assert steps == [5, 6, 7, 8]
        assert not pipe._thread.is_alive()


class TestCheckpoint:
    def test_roundtrip_async_atomic(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tree = {"a": {"b": torch.arange(10, dtype=torch.float32)},
                "c": [torch.ones((2, 2)), torch.zeros((3,))]}
        mgr.save(1, tree)
        mgr.save(2, tree)
        mgr.save(3, tree, blocking=True)
        assert mgr.all_steps() == [2, 3]  # retention
        got, step = mgr.restore(device=CPU)
        assert step == 3
        assert torch.equal(got["a"]["b"], torch.arange(10, dtype=torch.float32))
        # lists come back as index-keyed dicts (flatten convention)
        assert torch.equal(got["c"]["0"], torch.ones((2, 2)))

    def test_no_tmp_dirs_left(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.zeros(4)}, blocking=True)
        assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]

    def test_restore_with_device(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.arange(8.0)}, blocking=True)
        got, _ = mgr.restore(device=CPU)
        assert got["x"].device == torch.device(CPU)


def test_restart_supervisor_recovers(tmp_path):
    """``TestFaultTolerance``'s restart test over the port's manager."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.zeros(2)}, blocking=True)
    calls = {"n": 0}

    def restore():
        state, step = mgr.restore(device=CPU)
        return step, state

    def loop(start, state):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("simulated node failure")
        return "done", start

    sup = RestartSupervisor(max_restarts=5)
    out, start = sup.run(loop, restore)
    assert out == "done" and start == 0 and sup.restarts == 2


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _np_tree(rs, dtype=np.float32):
    """A small parameter-like tree: a matrix, a vector and a nested leaf."""
    return {"blocks": {"w": rs.randn(3, 5, 4).astype(dtype),
                       "g": (1 + 0.1 * rs.randn(5)).astype(dtype)},
            "embed": {"e": rs.randn(7, 4).astype(dtype)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return jax.tree.map(lambda a: to_torch(a), tree)


def test_cosine_schedule_matches_jax():
    """At step 0, inside warmup, at warmup, mid-decay, at total and past
    it, in f32: JAX's and the port's cos are each within an ulp of the
    exact value, so the two agree within 2 ulps of peak_lr (measured:
    equal at all six)."""
    for step in (0, 3, 10, 55, 100, 130):
        j = jadamw.cosine_schedule(jnp.int32(step), peak_lr=3e-4, warmup=10,
                                   total=100)
        t = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                            peak_lr=3e-4, warmup=10, total=100)
        assert t.dtype == torch.float32 and t.shape == ()
        assert_same(t, j, atol=2 * U32 * 3e-4, what=f"step {step}")
    assert float(cosine_schedule(torch.tensor(0), peak_lr=1e-2, warmup=1,
                                 total=5)) == 0.0


def test_global_norm_clip_matches_jax():
    """The norm sums the leaves in JAX's order (dict keys sorted); inside
    a leaf the two packages add in other orders: within gamma_n of the
    sum of squares, n the element count (here 84), halved by the sqrt."""
    rs = np.random.RandomState(3)
    g = _np_tree(rs)
    jc, jn = jadamw.global_norm_clip(_jax(g), 0.5)
    tc, tn = global_norm_clip(_port(g), 0.5)
    n = sum(a.size for a in jax.tree.leaves(g))
    tol = n * U32 * float(jn)
    assert_same(tn, jn, atol=tol, what="norm")
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        assert b.dtype == torch.float32
        assert_same(b, a, atol=tol * float(np.abs(np.asarray(a)).max()) * 4,
                    what="clipped")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(param_dtype):
    """Four updates of the same tree from the same gradients (the first at
    lr 0): ``step`` equal; the norm within gamma_n of itself (n the 84
    elements); m, v and the f32 master within 8 i ulps of the leaf's
    largest magnitude after update i: each package rounds an update of v
    at most 4 times (g^2, two products, the sum; m 3 times, the master
    about as often), each within an ulp of that magnitude, and an earlier
    difference carries on scaled by b1, b2 < 1 (measured at most 5.3 ulps
    after the fourth: XLA and PyTorch fuse the products and sums at other
    points); every new parameter has ``param_dtype``, and after lr 0
    equals the parameter before, bit for bit."""
    rs = np.random.RandomState(4)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    p0 = _np_tree(rs)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jd), p0)
    tparams = _port(jax.tree.map(np.asarray, jparams))
    jst, tst = jadamw.adamw_init(jparams), adamw_init(tparams)
    for i, lr in enumerate((0.0, 1e-2, 3e-3, 1e-3)):
        g = {k: {n: (rs.randn(*a.shape) * 0.3).astype(np.float32)
                 for n, a in v.items()} for k, v in p0.items()}
        jg = jax.tree.map(lambda a: jnp.asarray(a, jd), g)
        jparams, jst, jm = jadamw.adamw_update(jg, jst, jnp.float32(lr),
                                               param_dtype=jd)
        before = jax.tree.map(torch.clone, tparams)
        tparams, tst, tm = adamw_update(
            _port(jax.tree.map(np.asarray, jg)), tst,
            torch.tensor(lr, dtype=torch.float32), param_dtype=td,
            params=tparams)
        assert int(tst.step) == int(jst.step) == i + 1
        assert_same(tm["grad_norm"], jm["grad_norm"],
                    atol=84 * U32 * float(jm["grad_norm"]))
        for name in ("master", "m", "v"):
            for a, b in zip(jax.tree.leaves(getattr(jst, name)),
                            jax.tree.leaves(getattr(tst, name))):
                mag = float(np.abs(np.asarray(a)).max())
                assert_same(b, a, atol=8 * (i + 1) * U32 * mag,
                            what=f"update {i} {name}")
        for a, b, b0 in zip(jax.tree.leaves(jparams),
                            jax.tree.leaves(tparams),
                            jax.tree.leaves(before)):
            assert b.dtype == td
            if lr == 0.0:
                assert torch.equal(b, b0)


def test_adamw_update_writes_params_in_place_and_casts_the_rest():
    """Leaves of ``param_dtype`` are written in place; a leaf of another
    dtype (the f32 norm gain of a bf16 tree) comes back as a new
    ``param_dtype`` tensor, as JAX casts every leaf."""
    params = {"w": torch.ones(4, dtype=torch.bfloat16),
              "g": torch.ones(4, dtype=torch.float32)}
    st = adamw_init(params)
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16),
         "g": torch.full((4,), 0.5)}
    new, st, _ = adamw_update(g, st, 1e-2, params=params)
    assert new["w"] is params["w"] and new["g"] is not params["g"]
    assert new["w"].dtype == new["g"].dtype == torch.bfloat16
    assert not torch.equal(new["w"], torch.ones(4, dtype=torch.bfloat16))


def test_adamw_chunks_a_large_leaf_like_a_small_one(monkeypatch):
    """A leaf updated in slices of ``CHUNK`` elements gets the same bits as
    one updated whole (the update is elementwise; the norm is summed per
    slice, here of exactly representable values), and so does a strided
    gradient (a transposed view, as a product's backward can give)."""
    from repro_torch.optim import adamw as tadamw
    rs = np.random.RandomState(5)
    w = torch.tensor(rs.randn(10, 7).astype(np.float32))
    g = torch.tensor(rs.randint(-8, 8, (10, 7)).astype(np.float32) / 8)
    outs = []
    for chunk, g in ((1 << 26, g), (16, g), (16, g.T.contiguous().T)):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        st = adamw_init({"w": w})
        p, st, _ = adamw_update({"w": g}, st, 1e-2,
                                param_dtype=torch.float32)
        outs.append((p["w"], st.m["w"], st.v["w"]))
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)


def test_compress_decompress_matches_jax():
    """Five rounds with error feedback on f32 and bf16 gradients: the int8
    codes equal; the dequantized values and the error feedback equal bit
    for bit (max, a division by 127, round half to even, one product and
    one difference, each correctly rounded in both packages)."""
    rs = np.random.RandomState(6)
    shapes = {"a": (33,), "b": (4, 9)}
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        jef = jcomp.compression_init(
            {k: jnp.zeros(s, jd) for k, s in shapes.items()})
        tef = compression_init({k: torch.zeros(s, dtype=td)
                                for k, s in shapes.items()})
        for r in range(5):
            g = {k: (rs.randn(*s) * 10 ** rs.uniform(-4, 1)).astype(
                np.float32) for k, s in shapes.items()}
            jg = jax.tree.map(lambda a: jnp.asarray(a, jd), g)
            tg = _port(jax.tree.map(np.asarray, jg))
            codes = {k: quantize(tg[k], tef[k])[0] for k in shapes}
            # JAX's codes, by its own formula on its own g + err
            jcodes = {}
            for k in shapes:
                gj = jg[k].astype(jnp.float32) + jef[k]
                scale = jnp.maximum(jnp.max(jnp.abs(gj)), 1e-12) / 127.0
                jcodes[k] = jnp.clip(jnp.round(gj / scale), -127, 127)
                jcodes[k] = (jcodes[k], scale)
            jdq, jef = jcomp.compress_decompress(jg, jef)
            tdq, tef = compress_decompress(tg, tef)
            for k in shapes:
                jq, scale = jcodes[k]
                assert np.array_equal(np.asarray(jq * scale),
                                      np.asarray(jdq[k]))
                assert codes[k].dtype == torch.int8
                assert np.array_equal(codes[k].numpy(),
                                      np.asarray(jq).astype(np.int8)), (r, k)
                assert_same(tdq[k], jdq[k], what=f"round {r} {k} dequant")
                assert_same(tef[k], jef[k], what=f"round {r} {k} feedback")


def test_synthetic_lm_matches_jax_bit_for_bit():
    for vocab, batch, seq, seed in ((512, 4, 16, 0), (151936, 2, 33, 3)):
        j = JSyntheticLM(vocab, batch, seq, seed)
        t = SyntheticLM(vocab, batch, seq, seed)
        for step in (0, 1, 17):
            a, b = j.batch_at(step), t.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                assert np.array_equal(a[k], b[k]), (vocab, step, k)


def test_prefetch_pipeline_puts_tensors_on_the_device():
    src = SyntheticLM(vocab=50, batch=2, seq=4, seed=1)
    pipe = PrefetchPipeline(src, device=CPU)
    try:
        step, b = next(pipe)
    finally:
        pipe.close()
    want = src.batch_at(0)
    assert step == 0
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int32 and b[k].device.type == CPU
        assert np.array_equal(b[k].numpy(), want[k])


def test_pipeline_and_restore_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefetchPipeline(SyntheticLM(10, 1, 2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(2)}, blocking=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore()


# -- checkpoints across the two packages ----------------------------------------

def _state_np(rs):
    return {"params": {"w": rs.randn(3, 4).astype(np.float32),
                       "blocks": [rs.randn(2).astype(np.float32)]},
            "opt": {"step": np.asarray(7, np.int32),
                    "idx": rs.randint(-9, 9, (5,)).astype(np.int32)}}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """f32 and int32 bit for bit; a bf16 leaf (ml_dtypes, header '<V2')
    comes back as torch.bfloat16, bit for bit."""
    rs = np.random.RandomState(7)
    tree = _state_np(rs)
    bf = jnp.asarray(rs.randn(6).astype(np.float32), jnp.bfloat16)
    JCheckpointManager(str(tmp_path)).save(
        3, {**_jax(tree), "bf": bf}, blocking=True)
    got, step = CheckpointManager(str(tmp_path)).restore(device=CPU)
    assert step == 3
    assert_same(got["params"]["w"], tree["params"]["w"])
    assert got["params"]["blocks"]["0"].dtype == torch.float32
    assert_same(got["params"]["blocks"]["0"], tree["params"]["blocks"][0])
    for k in ("step", "idx"):
        assert got["opt"][k].dtype == torch.int32
        assert np.array_equal(got["opt"][k].numpy(), tree["opt"][k])
    assert got["bf"].dtype == torch.bfloat16
    assert np.array_equal(got["bf"].view(torch.int16).numpy(),
                          np.asarray(bf).view(np.int16))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """f32 and int32 bit for bit in the JAX package's reader; the port's
    bf16 file is byte for byte the one the JAX package writes for the same
    values (and the JAX reader, like its own files, gives void |V2)."""
    rs = np.random.RandomState(8)
    tree = _state_np(rs)
    vals = rs.randn(6).astype(np.float32)
    bf_t = torch.tensor(vals).to(torch.bfloat16)
    CheckpointManager(str(tmp_path / "port")).save(
        5, {**_port(tree), "bf": bf_t}, blocking=True)
    got, step = JCheckpointManager(str(tmp_path / "port")).restore()
    assert step == 5
    assert np.array_equal(got["params"]["w"], tree["params"]["w"])
    assert np.array_equal(got["params"]["blocks"]["0"],
                          tree["params"]["blocks"][0])
    assert got["opt"]["step"].dtype == np.int32
    assert np.array_equal(got["opt"]["idx"], tree["opt"]["idx"])
    assert got["bf"].dtype == np.dtype("V2")
    JCheckpointManager(str(tmp_path / "jax")).save(
        5, {"bf": jnp.asarray(vals, jnp.bfloat16)}, blocking=True)
    a = (tmp_path / "port" / "step_5" / "bf.npy").read_bytes()
    b = (tmp_path / "jax" / "step_5" / "bf.npy").read_bytes()
    assert a == b
    with open(tmp_path / "port" / "step_5" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["bf"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"


def test_bf16_round_trip_in_the_port(tmp_path):
    """Every bf16 bit pattern, NaN and infinities included, comes back."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).reshape(256, 256)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x, "s": torch.tensor(2.5, dtype=torch.bfloat16)},
             blocking=True)
    got, _ = mgr.restore(device=CPU)
    assert got["x"].dtype == torch.bfloat16 and got["x"].shape == x.shape
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    assert got["s"].shape == () and float(got["s"]) == 2.5


def test_save_snapshots_before_returning(tmp_path):
    """The state is copied to the host before ``save`` returns, so an
    update in place right after it does not reach the files."""
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros(1000)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    got, _ = mgr.restore(device=CPU)
    assert torch.equal(got["x"], torch.zeros(1000))


def test_write_error_is_raised_at_the_next_wait(tmp_path, monkeypatch):
    def fail(path, v):
        raise OSError("disk full")

    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(cm, "_save", fail)
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.all_steps() == []


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(device=CPU)


def test_state_is_an_adamw_state():
    st = adamw_init({"w": torch.ones(2, dtype=torch.bfloat16)})
    assert isinstance(st, AdamWState)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    assert st.master["w"].dtype == torch.float32
