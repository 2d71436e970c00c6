"""The port's ``tm_compile`` (a ``make_fx`` front end) against the JAX
package's (``jax.make_jaxpr``), on the CPU.

* Each aten matcher, one op at a time, builds the TM instruction the JAX
  matcher builds for the equivalent lax primitive (maps compared by their
  JSON encoding).
* The models' NHWC conv and max pool reach a trace as ONE node each, and
  compute what they computed before they were custom ops.
* Every ``COMPILED_CASES`` case has a torch twin (``TWINS``, beside the
  harness table, which this file imports and does not edit); on every dtype
  and variant, after the pass pipeline, both packages give the same TM
  instruction count and phase-kind string, the same lowering paths
  (``pallas.`` -> ``cuda.``, launches, instructions) and the same outputs:
  bit-exact for data movement, ESPCN within its derived float32 bound.

One difference is the JAX package's, not the port's: under the installed
JAX (0.9) ``jnp.pad`` traces as a ``jit`` sub-jaxpr, which the JAX front
end does not inline (it inlines ``pjit``), so the pad stays an opaque
compute node there.  ``superres_tail`` ends in ``jnp.pad``; its structure
is held against the JAX trace of the same function written with
``lax.pad`` (``_superres_lax_pad``), its outputs against the case itself.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.compiler import tm_compile as jtm_compile  # noqa: E402
from repro.compiler.trace import graph_from_jaxpr  # noqa: E402
from repro.core import tm_ops as jtm_ops  # noqa: E402
from repro.core.tm_primitive import tag_tm_ops as jtag  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.compiler.trace import graph_from_fx  # noqa: E402
from repro_torch.core import tm_ops  # noqa: E402
from repro_torch.core.tm_primitive import tag_tm_ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from tests.harness import COMPILED_CASES  # noqa: E402
from tests.test_torch_support import (assert_same, assert_within,  # noqa: E402
                                      espcn_f64, to_torch)

def _espcn_params(dtype: str):
    return jcnn.init_espcn(jax.random.PRNGKey(0), s=2, dtype=jnp.dtype(dtype))


# COMPILED_CASES twins (tests/harness.py:427): the same function in the
# port, given the JAX case's dtype (its weights come from the JAX
# package's init, carried across with params_from_numpy)
TWINS = {
    "superres_tail": lambda dtype: (
        lambda a, b: tcnn.superres_tail(a, b, s=2)),
    "espcn": lambda dtype: tcnn.ESPCN(params_from_numpy(
        jax.tree.map(np.asarray, _espcn_params(dtype)))),
    "yolo_neck": lambda dtype: tcnn.yolo_neck,
    "detect_tail": lambda dtype: (lambda p: tcnn.detect_tail(p, 10.0, 16)),
}


def _superres_lax_pad(x, skip, s=2):
    """harness ``superres_tail`` with ``lax.pad`` where it has
    ``jnp.pad``: the same function, its pad visible to the JAX trace."""
    B, H, W, C = x.shape
    c = C // (s * s)
    h = x.reshape(B, H, W, s, s, c)
    h = jnp.transpose(h, (0, 1, 3, 2, 4, 5))
    h = h.reshape(B, H * s, W * s, c)
    h = h + skip
    h = jax.lax.slice(h, (0, s, s, 0), (B, H * s - s, W * s - s, c))
    return jax.lax.pad(h, jnp.zeros((), h.dtype),
                       ((0, 0, 0), (1, 1, 0), (1, 1, 0), (0, 0, 0)))


def _kinds(compiled) -> str:
    return "".join({"tpu": "t", "tmu": "m", "fused": "f"}[p.kind]
                   for p in compiled.partition_report.phases)


def _records(reps, prefix="pallas."):
    return [(r.path.replace(prefix, "cuda.", 1), r.launches, r.instrs)
            for rep in reps for r in rep.records]


# ---------------------------------------------------------------------------
# the matchers, one aten op at a time
# ---------------------------------------------------------------------------

def _x(rng, shape):
    return rng.rand(*shape).astype(np.float32)


# name -> (torch fn, JAX fn, input shapes)
MATCHERS = {
    "permute": (lambda x: x.permute(2, 0, 1),
                lambda x: jax.lax.transpose(x, (2, 0, 1)), [(4, 6, 5)]),
    "t": (lambda x: x.t(), lambda x: jax.lax.transpose(x, (1, 0)),
          [(4, 6)]),
    "transpose": (lambda x: x.transpose(0, 2),
                  lambda x: jax.lax.transpose(x, (2, 1, 0)), [(4, 6, 5)]),
    "view": (lambda x: x.view(24, 5),
             lambda x: jax.lax.reshape(x, (24, 5)), [(4, 6, 5)]),
    "view_split": (lambda x: x.view(2, 2, 30),
                   lambda x: jax.lax.reshape(x, (2, 2, 30)), [(4, 6, 5)]),
    "squeeze": (lambda x: x.squeeze(1),
                lambda x: jax.lax.squeeze(x, (1,)), [(4, 1, 5)]),
    "unsqueeze": (lambda x: x.unsqueeze(1),
                  lambda x: jax.lax.reshape(x, (4, 1, 5)), [(4, 5)]),
    "slice": (lambda x: x[:, 1:6:2],
              lambda x: jax.lax.slice(x, (0, 1, 0), (4, 6, 5), (1, 2, 1)),
              [(4, 7, 5)]),
    "slice_negative_start": (lambda x: x[-3:],
                             lambda x: jax.lax.slice(x, (4, 0), (7, 5)),
                             [(7, 5)]),
    "constant_pad_nd": (lambda x: F.pad(x, (1, 2, 0, 1), value=3.0),
                        lambda x: jax.lax.pad(x, jnp.float32(3.0),
                                              ((0, 0, 0), (0, 1, 0),
                                               (1, 2, 0))), [(4, 6, 5)]),
    "constant_pad_crop": (lambda x: F.pad(x, (-1, 2)),
                          lambda x: jax.lax.pad(x, jnp.float32(0.0),
                                                ((0, 0, 0), (-1, 2, 0))),
                          [(4, 6)]),
    "cat": (lambda a, b: torch.cat([a, b], 1),
            lambda a, b: jax.lax.concatenate([a, b], 1),
            [(4, 2, 5), (4, 3, 5)]),
    "flip": (lambda x: torch.flip(x, [0, 2]),
             lambda x: jax.lax.rev(x, (0, 2)), [(4, 6, 5)]),
    "expand": (lambda x: x.expand(3, 4, 5),
               lambda x: jax.lax.broadcast_in_dim(x, (3, 4, 5), (1, 2)),
               [(4, 5)]),
    "add": (lambda a, b: a + b, jax.lax.add, [(4, 5), (4, 5)]),
    "sub": (lambda a, b: a - b, jax.lax.sub, [(4, 5), (4, 5)]),
    "mul": (lambda a, b: a * b, jax.lax.mul, [(4, 5), (4, 5)]),
    "maximum": (torch.maximum, jax.lax.max, [(4, 5), (4, 5)]),
    "tm_map": (lambda x: tm_ops.pixel_shuffle(x, 2),
               lambda x: jtm_ops.pixel_shuffle(x, 2), [(2, 3, 5, 8)]),
    "tm_route": (lambda a, b: tm_ops.route([a, b]),
                 lambda a, b: jtm_ops.route([a, b]),
                 [(2, 3, 5, 4), (2, 3, 5, 2)]),
    "tm_resize": (lambda x: tm_ops.resize_bilinear(x, 7, 3),
                  lambda x: jtm_ops.resize_bilinear(x, 7, 3), [(2, 5, 6, 3)]),
    "tm_evaluate": (lambda x: tm_ops.bboxcal_rows(x, 0.5, 4),
                    lambda x: jtm_ops.bboxcal_rows(x, 0.5, 4),
                    [(2, 9, 6)]),
}


def _port_graph(fn, *xs):
    with tag_tm_ops():
        gm = make_fx(fn)(*[torch.tensor(x) for x in xs])
    return graph_from_fx(gm)


def _jax_graph(fn, *xs):
    with jtag():
        closed = jax.make_jaxpr(fn)(*[jnp.asarray(x) for x in xs])
    return graph_from_jaxpr(closed)


def _instr_key(ins):
    return (ins.opcode.value,
            None if ins.map_ is None else ins.map_.encode(),
            None if ins.maps is None else [m.encode() for m in ins.maps],
            None if ins.ew is None else ins.ew.value,
            None if ins.rme is None else ins.rme.encode(),
            ins.meta, len(ins.srcs))


@pytest.mark.parametrize("name", list(MATCHERS))
def test_matcher_builds_the_jax_instruction(name, rng):
    tfn, jfn, shapes = MATCHERS[name]
    xs = [_x(rng, s) for s in shapes]
    tg, jg = _port_graph(tfn, *xs), _jax_graph(jfn, *xs)
    (tn,), (jn,) = tg.tm_nodes(), jg.tm_nodes()
    assert not tg.tpu_nodes() and not jg.tpu_nodes()
    assert _instr_key(tn.instr) == _instr_key(jn.instr)


def test_clone_is_a_copy_and_a_reshape_clone_is_not(rng):
    x = torch.tensor(_x(rng, (4, 6, 5)))
    g = _port_graph(lambda a: a.clone(), x.numpy())
    (n,) = g.tm_nodes()
    assert n.instr.opcode.value == "copy"
    # reshape of a non-contiguous tensor: aten's clone + _unsafe_view is the
    # one reshape a jaxpr has
    g = _port_graph(lambda a: a.permute(1, 0, 2).reshape(24, 5), x.numpy())
    assert [n.matched for n in g.tm_nodes()] == ["permute", "_unsafe_view"]
    jg = _jax_graph(lambda a: jnp.transpose(a, (1, 0, 2)).reshape(24, 5),
                    x.numpy())
    assert [_instr_key(n.instr) for n in g.tm_nodes()] == [
        _instr_key(n.instr) for n in jg.tm_nodes()]


def test_compute_stays_opaque_and_constants_fold(rng):
    w = torch.tensor(_x(rng, (5, 3)))
    g = _port_graph(lambda a: torch.tanh(a @ (w.t().t() * 2)),
                    _x(rng, (4, 5)))
    assert [n.primitive_name for n in g.tpu_nodes()] == ["mm", "tanh"]
    assert not g.tm_nodes()  # the weight's t().t() * 2 folded at trace time
    mm = g.tpu_nodes()[0]
    assert torch.equal(g.consts[mm.src_names[1]], w * 2)


def test_module_parameters_are_constants_on_their_device(rng):
    m = tcnn.init_espcn(torch.Generator().manual_seed(0), s=2, device="cpu")
    c = tm_compile(m, torch.tensor(_x(rng, (1, 5, 6, 3))))
    params = {p.data_ptr() for p in m.parameters()}
    assert {v.data_ptr() for v in c.graph.consts.values()} == params
    assert all(v.device.type == "cpu" for v in c.graph.consts.values())


# ---------------------------------------------------------------------------
# the conv and the pool: one node each
# ---------------------------------------------------------------------------

def test_conv_and_pool_are_one_node_each(rng):
    y = tcnn.init_yolov3_tiny(torch.Generator().manual_seed(0), n_classes=3,
                              device="cpu")
    with tag_tm_ops():
        gm = make_fx(y)(torch.tensor(_x(rng, (1, 32, 32, 3))))
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.conv2d_nhwc.default") == 11
    assert targets.count("repro_torch.max_pool_nhwc.default") == 5
    assert not any(t.startswith(("aten.permute", "aten.constant_pad_nd",
                                 "aten.convolution", "aten.max_pool"))
                   for t in targets)
    # through the compiler: the conv and the pool are compute nodes
    c = tm_compile(y, torch.tensor(_x(rng, (1, 32, 32, 3))))
    names = [n.primitive_name for n in c.graph.tpu_nodes()]
    assert names.count("conv2d_nhwc") == 11
    assert names.count("max_pool_nhwc") == 5


@pytest.mark.parametrize("stride,pad", [(1, "SAME"), (2, "SAME"),
                                        (2, "VALID")])
def test_conv_custom_op_is_the_former_code(stride, pad, rng):
    """The custom op runs the code conv2d ran before: permute to NCHW, the
    SAME padding, F.conv2d, back to NHWC — bit for bit; and max pool."""
    x = torch.tensor(_x(rng, (2, 9, 8, 5)))
    w = torch.tensor(_x(rng, (3, 3, 5, 7)) - 0.5)
    xn = x.permute(0, 3, 1, 2)
    if pad == "SAME":
        (t, b), (le, r) = (tcnn._same_pad(9, 3, stride),
                           tcnn._same_pad(8, 3, stride))
        xn = F.pad(xn, (le, r, t, b))
    ref = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    got = tcnn.conv2d(x, w, stride=stride, pad=pad)
    assert torch.equal(got, ref.permute(0, 2, 3, 1).contiguous())
    pooled = tcnn.max_pool_same(x)
    xp = F.pad(x.permute(0, 3, 1, 2), (0, 0, 0, 1), value=-float("inf"))
    assert torch.equal(pooled, F.max_pool2d(xp, 2, 2).permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# COMPILED_CASES twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,dtype", [(c, d) for c in COMPILED_CASES
                                         for d in c.dtypes],
                         ids=[f"{c.name}-{d}" for c in COMPILED_CASES
                              for d in c.dtypes])
def test_compiled_case_twin(case, dtype):
    for variant in case.variants:
        rng = np.random.RandomState(31)
        fn, args = case.build(dtype, variant, rng)
        targs = [to_torch(a) for a in args]
        twin = TWINS[case.name](dtype)
        port = tm_compile(twin, *targs)
        jfn = _superres_lax_pad if case.name == "superres_tail" else fn
        ref = jtm_compile(jfn, *args)
        what = (case.name, dtype, variant)
        # structure after the pass pipeline
        assert len(port.graph.tm_nodes()) == len(ref.graph.tm_nodes()), what
        assert port.phase_kinds == _kinds(ref), what
        jout, jreps = ref.run(*args, backend="pallas")
        assert jtm_compile(fn, *args).graph.tm_nodes() or \
            case.name != "superres_tail"
        want = fn(*args)
        for backend in ("reference", "fused", "cuda"):
            got, reps = port.run(*targs, backend=backend)
            if backend == "cuda":
                assert _records(reps) == _records(jreps), what
            if case.name == "espcn":
                _espcn_within(dtype, args[0], want, got, what)
            else:
                assert_same(want, got, what=f"{what} {backend}")
                assert_same(jout, got, what=f"{what} {backend} vs JAX")


def _espcn_within(dtype, x, want, got, what):
    """float32: within the derived bound of the float64 network (and of
    JAX's output); bfloat16: within 2 bf16 ulps of the JAX output (both
    round each conv's f32 sum to bf16, then tanh in bf16)."""
    if dtype == "float32":
        ref, bound = espcn_f64(jax.tree.map(np.asarray, _espcn_params(dtype)),
                               np.asarray(x, np.float32))
        assert_within(got, ref, bound, what=str(what))
        assert_within(want, ref, bound, what=str(what))
        return
    from repro_torch.core.fp_bounds import bf16_ulp
    w = to_torch(want).to(torch.float64)
    tol = 8 * bf16_ulp(w)
    assert bool(((got.to(torch.float64) - w).abs() <= tol).all()), what


# ---------------------------------------------------------------------------
# the compiled signature
# ---------------------------------------------------------------------------

def _neck():
    u = torch.rand(2, 3, 4, 6)
    s = torch.rand(2, 6, 8, 3)
    return tm_compile(tcnn.yolo_neck, u, s), u, s


def test_compile_rejects_wrong_shape():
    c, u, s = _neck()
    with pytest.raises(TypeError, match="does not match"):
        c(torch.rand(2, 3, 5, 6), s)


def test_compile_rejects_wrong_dtype():
    c, u, s = _neck()
    with pytest.raises(TypeError, match="does not match"):
        c(u.to(torch.bfloat16), s)


def test_compile_rejects_wrong_structure_and_device():
    c, u, s = _neck()
    with pytest.raises(TypeError, match="structure"):
        c((u, s))
    with pytest.raises(TypeError, match="compiled for cpu"):
        c(u.to("meta"), s)


def test_compiled_program_runs_on_its_arguments_device():
    c, u, s = _neck()
    assert c.device == torch.device("cpu")
    out = c(u, s, backend="cuda")
    assert out.device.type == "cpu"
    assert [r.path for rep in c.last_lowering for r in rep.records] == [
        "cuda.gather", "cuda.route"]
    with pytest.raises(ValueError, match="one device"):
        tm_compile(tcnn.yolo_neck, u, s.to("meta"))


def test_report_prints_every_stage():
    c, _, _ = _neck()
    rep = c.report()
    for part in ("TMGraph:", "pass pipeline:", "phases [M]", "scratch:"):
        assert part in rep


def test_encode_map_is_the_jax_packages_string():
    from repro.core import affine as jaf
    from repro.core.tm_primitive import encode_map as jencode
    from repro_torch.core import affine as taf
    from repro_torch.core.tm_primitive import encode_map
    for name, args in (("pixel_shuffle_map", ((4, 6, 8), 2)),
                       ("upsample_map", ((3, 5, 2), 2)),
                       ("rearrange_map", ((6, 8, 3), 1, 16)),
                       ("pad_map", ((4, 5), (1, 0), (0, 2), 7.0))):
        assert encode_map(getattr(taf, name)(*args)) == \
            jencode(getattr(jaf, name)(*args)), name


def test_phase_hbm_bytes_counts_reads_and_writes():
    c, u, s = _neck()
    (ph,) = c.partition_report.phases
    want = sum(math.prod(c.graph.shape(n)) * 4
               for n in tuple(ph.reads) + tuple(ph.writes))
    assert c._phase_hbm_bytes(ph) == want == (u.numel() + s.numel()
                                              + 2 * 6 * 8 * 9) * 4
