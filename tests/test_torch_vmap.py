"""The port's custom ops under ``torch.func.vmap``, on the CPU.

The serving layer compiles ``torch.func.vmap(fn)`` (the JAX package's
``jax.vmap``).  Every custom op of the port has a vmap rule, the
counterpart of the JAX batchers (``repro/core/tm_primitive.py``): the TM
ops move the mapped axis to the front and grow ``batch_dims``; the NHWC
conv and max pool take the mapped axis as one more leading batch axis.
Without the rules PyTorch falls back to a loop over the samples, and a
compiled batch of 8 held 8 copies of every TM instruction.

* Per op: the vmapped op equals the loop over samples — bit-exact for the
  TM ops and the pool, the conv within ``conv_tol`` — with the per-sample
  fallback turned off, so an op without a rule raises.
* Per demo block (``superres_tail``, ``yolo_neck``, ``detect_tail``,
  ESPCN): ``tm_compile(torch.func.vmap(fn), *stacked)`` has the batched
  call's TM instruction count and phase kinds at batch 1, 4 and 8, no
  fallback warning, and its outputs equal the JAX package's direct calls
  per sample (ESPCN within ``ESPCN_ATOL``).
* The compiler faults the rules exposed: copy elimination rewires a
  compute node's arguments, and TM tagging and tracing are per thread.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.core import affine as af  # noqa: E402
from repro_torch.core import tm_primitive as tp  # noqa: E402
from repro_torch.core.fp_bounds import conv_tol  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from tests.test_torch_models import ESPCN_ATOL  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

ft = torch._C._functorch


class _NoFallback:
    """``torch.func.vmap`` raises where an op has no vmap rule, in place of
    looping over the samples."""

    def __enter__(self):
        self.prev = ft._is_vmap_fallback_enabled()
        ft._set_vmap_fallback_enabled(False)

    def __exit__(self, *exc):
        ft._set_vmap_fallback_enabled(self.prev)


def _loop(fn, *args):
    return torch.stack([fn(*(a[i] for a in args))
                        for i in range(args[0].shape[0])])


def _rand(rng, *shape):
    return to_torch(rng.rand(*shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the rules, op by op
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def no_rule_op():
    """An op with no vmap rule: what the fallback guard must catch."""
    op = torch.library.custom_op("repro_torch_test::no_rule",
                                 mutates_args=(),
                                 schema="(Tensor x) -> Tensor")(
        lambda x: x * 2)
    op.register_fake(lambda x: torch.empty_like(x))
    return op


def test_the_fallback_guard_catches_an_op_without_a_rule(no_rule_op):
    x = torch.ones(3, 2)
    assert torch.equal(torch.func.vmap(no_rule_op)(x), x * 2)  # a loop
    with _NoFallback(), pytest.raises(RuntimeError):
        torch.func.vmap(no_rule_op)(x)


def test_tm_map_rule_moves_the_axis_and_grows_batch_dims():
    rng = np.random.RandomState(0)
    m = af.pixel_shuffle_map((3, 4, 8), 2)
    js = tp.encode_map(m)
    x = _rand(rng, 3, 2, 3, 4, 8)        # mapped axis 0 of 3, batch_dims 1
    with _NoFallback():
        got = torch.func.vmap(lambda v: tp.tm_map(v, js, 1))(x)
        moved = torch.func.vmap(lambda v: tp.tm_map(v, js, 1),
                                in_dims=1)(x.movedim(0, 1))
    want = _loop(lambda v: tp.tm_map(v, js, 1), x)
    assert torch.equal(got, want) and torch.equal(moved, want)


def test_tm_route_rule_broadcasts_an_unmapped_band():
    rng = np.random.RandomState(1)
    maps = af.route_maps([(4, 5, 2), (4, 5, 3)])
    js = [tp.encode_map(m) for m in maps]
    a, b = _rand(rng, 6, 4, 5, 2), _rand(rng, 4, 5, 3)

    def route(u, v):
        return tp.tm_route([u, v], js, 0)

    with _NoFallback():
        got = torch.func.vmap(route, in_dims=(0, None))(a, b)
    want = torch.stack([route(a[i], b) for i in range(6)])
    assert torch.equal(got, want)


def test_tm_resize_and_evaluate_rules_move_the_axis_to_the_front():
    rng = np.random.RandomState(2)
    x = _rand(rng, 3, 6, 5, 4)
    rows = _rand(rng, 2, 3, 20, 6)       # mapped axis 1 of 3
    with _NoFallback():
        got_r = torch.func.vmap(lambda v: tp.tm_resize(v, 9, 7))(x)
        got_e = torch.func.vmap(
            lambda v: tp.tm_evaluate(v, 0.5, 8, "ge", 4), in_dims=1)(rows)
    assert torch.equal(got_r, _loop(lambda v: tp.tm_resize(v, 9, 7), x))
    want_e = _loop(lambda v: tp.tm_evaluate(v, 0.5, 8, "ge", 4),
                   rows.movedim(1, 0))
    assert torch.equal(got_e, want_e)


def test_conv_and_pool_rules_fold_the_mapped_axis():
    rng = np.random.RandomState(3)
    x = _rand(rng, 4, 2, 7, 9, 3)        # 4 samples of a (2, 7, 9, 3) batch
    w = to_torch((rng.randn(3, 3, 3, 5) * 0.3).astype(np.float32))
    with _NoFallback():
        conv = torch.func.vmap(
            lambda v: cnn.conv2d_nhwc(v, w, 1, "SAME"))(x)
        pool = torch.func.vmap(lambda v: cnn.max_pool_nhwc(v, 2, 2))(x)
    loop = _loop(lambda v: cnn.conv2d_nhwc(v, w, 1, "SAME"), x)
    tol = torch.stack([conv_tol(x[i, j], w, 1, 1) for i in range(4)
                       for j in range(2)]).reshape(loop.shape)
    assert ((conv.double() - loop.double()).abs() <= tol).all()
    assert torch.equal(pool, _loop(lambda v: cnn.max_pool_nhwc(v, 2, 2), x))
    with pytest.raises(NotImplementedError, match="weights"):
        torch.func.vmap(lambda v, u: cnn.conv2d_nhwc(v, u, 1, "SAME"))(
            x, w.expand(4, *w.shape))


# ---------------------------------------------------------------------------
# the demo blocks through tm_compile
# ---------------------------------------------------------------------------

def _espcn_pair():
    jp = jcnn.init_espcn(jax.random.PRNGKey(0), s=2)
    return jp, cnn.ESPCN(params_from_numpy(jax.tree.map(np.asarray, jp)))


def _blocks():
    """name -> (port fn, JAX fn, per-request shapes, batched-call form)."""
    jp, esp = _espcn_pair()

    def fold(a):                          # (B, 1, ...) -> (B, ...)
        return a.reshape((-1,) + tuple(a.shape[2:]))

    return {
        "superres_tail": (cnn.superres_tail, jcnn.superres_tail,
                          [(1, 6, 10, 8), (1, 12, 20, 2)], fold),
        "yolo_neck": (cnn.yolo_neck, jcnn.yolo_neck,
                      [(1, 4, 6, 6), (1, 8, 12, 3)], fold),
        # the RME rows with a leading batch axis
        "detect_tail": (lambda p: cnn.detect_tail(p, 0.5, 16),
                        lambda p: jcnn.detect_tail(p, 0.5, 16),
                        [(2, 33, 7)], lambda a: a),
        "espcn": (esp, lambda x: jcnn.espcn(jp, x), [(1, 8, 10, 3)], fold),
    }


@pytest.mark.parametrize("batch", (1, 4, 8))
@pytest.mark.parametrize("name", ("superres_tail", "yolo_neck",
                                  "detect_tail", "espcn"))
def test_vmapped_block_compiles_as_the_batched_call(name, batch, capfd):
    fn, jfn, shapes, batched = _blocks()[name]
    rng = np.random.RandomState(batch)
    np_args = [rng.rand(batch, *s).astype(np.float32) for s in shapes]
    args = [to_torch(a) for a in np_args]
    with _NoFallback():
        cv = tm_compile(torch.func.vmap(fn), *args)
    cb = tm_compile(fn, *(batched(a) for a in args))
    assert cv.phase_kinds == cb.phase_kinds
    assert [len(p.instrs) for p in cv.tm_programs] == \
        [len(p.instrs) for p in cb.tm_programs]
    assert "BatchedFallback" not in capfd.readouterr().err
    out = cv(*args, backend="cuda")
    for i in range(batch):
        ref = jfn(*(jnp.asarray(a[i]) for a in np_args))
        assert_same(out[i], ref, atol=ESPCN_ATOL if name == "espcn" else 0.0,
                    what=f"{name} sample {i}")


@pytest.mark.parametrize("cross_engine", (False, True))
def test_vmapped_yolo_keeps_its_phases_and_crossings(cross_engine):
    """YOLOv3-Tiny (small) under vmap: the batched call's phases, the
    same TM instructions, and bit-exact outputs — also where the crossings
    lower as one cross-engine launch (the conv's leading axes fold into
    its batch)."""
    gen = torch.Generator().manual_seed(0)
    model = cnn.init_yolov3_tiny(gen, n_classes=3, device="cpu")
    x = torch.rand((2, 1, 64, 64, 3), generator=gen)
    with _NoFallback():
        cv = tm_compile(torch.func.vmap(model), x, cross_engine=cross_engine)
    cb = tm_compile(model, x[:, 0], cross_engine=cross_engine)
    assert cv.phase_kinds == cb.phase_kinds == \
        ("ftf" if cross_engine else "mtmt")
    (v1, v2), reps_v = cv.run(x, backend="cuda", fuse_chains=True)
    (b1, b2), reps_b = cb.run(x[:, 0], backend="cuda", fuse_chains=True)
    assert [r.path for rep in reps_v for r in rep.records] == \
        [r.path for rep in reps_b for r in rep.records]
    assert torch.equal(v1[:, 0], b1) and torch.equal(v2[:, 0], b2)


# ---------------------------------------------------------------------------
# what the rules exposed in the compiler
# ---------------------------------------------------------------------------

def test_copy_elimination_rewires_a_compute_nodes_arguments():
    """An identity permute feeding a conv (what vmap's movedim leaves) is
    elided; the conv must then read the permute's source through its call
    arguments too, not only its recorded sources."""
    rng = np.random.RandomState(5)
    w = to_torch((rng.randn(3, 3, 2, 4) * 0.3).astype(np.float32))

    def fn(x):
        return torch.tanh(cnn.conv2d(x.permute(0, 1, 2, 3), w))

    x = _rand(rng, 1, 6, 5, 2)
    compiled = tm_compile(fn, x)
    assert compiled.pass_report.copies_elided >= 1
    assert torch.equal(compiled(x, backend="cuda"), fn(x))


def test_tagging_is_per_thread():
    seen = {}
    inside, release = threading.Event(), threading.Event()

    def tagger():
        with tp.tag_tm_ops():
            seen["tagger"] = tp.tagging()
            inside.set()
            release.wait(timeout=30)

    t = threading.Thread(target=tagger)
    t.start()
    assert inside.wait(timeout=30)
    seen["other"] = tp.tagging()
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"tagger": True, "other": False}


def test_concurrent_compiles_give_the_same_program():
    rng = np.random.RandomState(6)
    u, skip = _rand(rng, 4, 1, 4, 6, 6), _rand(rng, 4, 1, 8, 12, 3)
    ref = tm_compile(torch.func.vmap(cnn.yolo_neck), u, skip)
    got, errors = [], []

    def worker():
        try:
            for _ in range(3):
                c = tm_compile(torch.func.vmap(cnn.yolo_neck), u, skip)
                got.append([ins.encode() for p in c.tm_programs
                            for ins in p.instrs])
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:2]
    want = [ins.encode() for p in ref.tm_programs for ins in p.instrs]
    assert len(got) == 12 and all(g == want for g in got)
