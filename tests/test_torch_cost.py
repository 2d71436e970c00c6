"""The port's aten cost counter (``launch/cost.py``) and the three custom
ops the dry-run traces, on the CPU.

The twins of ``tests/test_hlo_cost.py``, rewritten for a counter over the
local aten ops of a run on meta tensors (a Python loop unrolls, so n
layers cost n times one and there are no trip counts): a straight-line
product, loops and nested loops, the bytes of a copy, a duplicated
operand, sliced reads, an update into a window, and the collectives' ring
factors on a fake process group.  Then ``torch.library.opcheck`` for
``rme_assemble``, ``flash_attention`` and ``flash_decode``, their FLOP
formulas under FlopCounterMode, and which placements their sharding rules
offer on a (2, 2) mesh of a fake group.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402
from torch.library import opcheck  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.launch.hlo_cost import analyze  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.rme_gather import rme_gather as rg  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _count(fn, *args):
    counter = CostCounter(args)
    with counter:
        fn(*args)
    return counter.totals


# -- the twins of tests/test_hlo_cost.py ----------------------------------------

def test_layer_loop_costs_n_times_one_layer():
    """The scan-trip-count twin: a loop of 8 layers costs exactly 8 times
    one layer, within 5% of 8 x 2MNK."""
    def layers(n):
        def f(x, ws):
            for i in range(n):
                x = torch.tanh(x @ ws[i])
            return x
        return f

    x, ws = _meta(256, 512), _meta(8, 512, 512)
    one, eight = _count(layers(1), x, ws), _count(layers(8), x, ws)
    assert eight.flops == 8 * one.flops and eight.bytes == 8 * one.bytes
    want = 8 * 2 * 256 * 512 * 512
    assert abs(eight.flops - want) / want < 0.05
    assert eight.matmul_flops == want


def test_matches_xla_on_straightline():
    """tanh(a @ b): within 10% of the JAX analyzer's FLOPs on the same
    product, and matmul_flops 2MNK exactly."""
    t = _count(lambda a, b: torch.tanh(a @ b), _meta(128, 256), _meta(256, 64))
    txt = jax.jit(lambda a, b: jnp.tanh(a @ b)).lower(
        jax.ShapeDtypeStruct((128, 256), jnp.float32),
        jax.ShapeDtypeStruct((256, 64), jnp.float32)).compile().as_text()
    xla = analyze(txt).flops
    assert abs(t.flops - xla) / xla < 0.1
    assert t.matmul_flops == 2 * 128 * 256 * 64


def test_nested_loops():
    def f(x, ws):
        for i in range(3):
            for j in range(4):
                x = torch.tanh(x @ ws[i, j])
        return x

    t = _count(f, _meta(64, 64), _meta(3, 4, 64, 64))
    want = 12 * 2 * 64 * 64 * 64
    assert abs(t.flops - want) / want < 0.10


def test_counts_ops_but_not_views():
    """The parse-structure twin: a*2+1 is two counted ops; a view, a
    transpose and an allocation are free."""
    t = _count(lambda a: (a * 2 + 1).view(2, 4).t(), _meta(8))
    assert t.ops == 2 and t.flops == 16


def test_bytes_reasonable_for_copy():
    t = _count(lambda a: a + 1.0, _meta(1024))
    # read 4 KB + write 4 KB
    assert 4096 <= t.bytes <= 5 * 4096


def test_update_into_window_counted_in_place():
    """A loop stacking its per-step outputs into a preallocated buffer:
    each step charges its window (the scan-ys twin), never the buffer."""
    n, width = 64, 4096

    def f(xs, ys):
        for i in range(n):
            ys[i] = torch.tanh(xs[i])
        return ys

    t = _count(f, _meta(n, width), _meta(n, width))
    stream = n * width * 4
    assert t.bytes < 8 * stream, t.bytes


def test_duplicated_operand_positions_both_charged():
    """One buffer passed to one op three times, once through a slice:
    each position charged at what it reads, the slice at its size."""
    x = _meta(128, 64)
    t = _count(lambda a: torch.addcmul(a[:1], a, a), x)
    assert t.bytes == 64 * 4 + 2 * 128 * 64 * 4 + 128 * 64 * 4, t.bytes


def test_sliced_parameter_reads():
    """A loop reading one slice of a stacked weight a step charges the
    slice, so every weight is read once, never 32 times."""
    def f(x, ws):
        for i in range(32):
            x = torch.tanh(x @ ws[i])
        return x

    t = _count(f, _meta(8, 256), _meta(32, 256, 256))
    w_bytes = 32 * 256 * 256 * 4
    assert t.bytes < 6 * w_bytes, t.bytes


@pytest.fixture(scope="module")
def fake4():
    """A fake process group of 4 ranks in this process (rank 0)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def test_collective_ring_factors(fake4):
    """Wire bytes per device: all-reduce 2 x its result, all-gather its
    result, reduce-scatter its operand, all-to-all its result."""
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    # a (64, 32) f32 tensor: 8 KB whole, 2 KB a shard
    cases = {"all-reduce": ([Partial()], [Replicate()], 2 * 8192),
             "all-gather": ([Shard(0)], [Replicate()], 8192),
             "reduce-scatter": ([Partial()], [Shard(0)], 8192)}
    for kind, (src, dst, wire) in cases.items():
        local = _meta(64, 32) if src == [Partial()] else _meta(16, 32)
        d = DTensor.from_local(local, mesh, src, run_check=False)
        t = _count(lambda a: a.redistribute(mesh, dst), d)
        assert t.coll == {kind: wire}, (kind, t.coll)
    # a CPU group has no all-to-all (DTensor's Shard(0) -> Shard(1) takes
    # an all-gather there): the functional collective itself
    t = _count(lambda a: funcol.all_to_all_single(a, None, None, group=mesh),
               _meta(16, 32))
    assert t.coll == {"all-to-all": 2048}, t.coll


# -- the custom ops ---------------------------------------------------------------

def _attn(rs, B=2, S=8, H=4, KV=2, D=16):
    q = torch.tensor(rs.randn(B, S, H, D).astype(np.float32))
    k = torch.tensor(rs.randn(B, S, KV, D).astype(np.float32))
    v = torch.tensor(rs.randn(B, S, KV, D).astype(np.float32))
    return q, k, v


def test_opcheck_rme_assemble():
    rs = np.random.RandomState(0)
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        x = torch.tensor(rs.randn(3, 10, 4)).to(dtype)
        for mask in (torch.tensor(rs.rand(3, 10) > 0.5),
                     torch.tensor(rs.randint(0, 3, (3, 10)),
                                  dtype=torch.int32)):
            opcheck(torch.ops.repro_torch.rme_assemble.default, (x, mask, 6))
    with FlopCounterMode(display=False) as f:
        rg.rme_assemble(x, mask, 6)
    assert f.get_total_flops() == 0  # a compaction does no product


def test_opcheck_flash_attention():
    rs = np.random.RandomState(1)
    q, k, v = _attn(rs)
    for causal, scale in ((True, None), (False, 0.3)):
        opcheck(torch.ops.repro_torch.flash_attention.default,
                (q, k, v, causal, scale))
        opcheck(torch.ops.repro_torch.flash_attention.default,
                (q[:, :, 0], k[:, :, 0], v[:, :, 0], causal, scale))
    with FlopCounterMode(display=False) as f:
        fa.flash_attention(q, k, v)
    assert f.get_total_flops() == 4 * 2 * 4 * 8 * 8 * 16


def test_opcheck_flash_decode():
    rs = np.random.RandomState(2)
    q, k, v = _attn(rs)
    for n in (0, 5, 8):
        opcheck(torch.ops.repro_torch.flash_decode.default,
                (q[:, :1], k, v, torch.tensor([n], dtype=torch.int32), None))
    with FlopCounterMode(display=False) as f:
        fa.flash_decode(q[:, :1], k, v, 5)
    assert f.get_total_flops() == 4 * 2 * 4 * 1 * 8 * 16


def _placed(mesh, t, placements):
    return distribute_tensor(t.to("meta"), mesh, placements)


def test_sharding_rules_keep_shards_local(fake4):
    """On a (2, 2) mesh, batch rows over "data": every op stays local to
    its shards; heads over "model" too when the KV heads divide the mesh
    (4 over 4), with no collective."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rs = np.random.RandomState(3)
    q, k, v = _attn(rs, H=8, KV=4)
    heads = [Shard(0), Shard(2)]
    dq, dk, dv = (_placed(mesh, t, heads) for t in (q, k, v))
    x = _placed(mesh, torch.zeros(8, 20, 3), [Shard(0), Replicate()])
    m = _placed(mesh, torch.zeros(8, 20, dtype=torch.bool),
                [Shard(0), Replicate()])
    with CommDebugMode() as comm:
        out = fa.flash_attention(dq, dk, dv)
        dec = fa.flash_decode(dq[:, :1], dk, dv, 5)
        rows, cnt = rg.rme_assemble(x, m, 4)
    assert comm.get_total_counts() == 0
    assert out.placements == tuple(heads) and dec.placements == tuple(heads)
    assert rows.placements == cnt.placements == (Shard(0), Replicate())
    assert rows.to_local().shape == (4, 4, 3)


def test_sharding_rules_refuse_heads_that_do_not_divide(fake4):
    """KV heads that do not divide the mesh (2 over 4): the heads strategy
    is not offered, since a rank's query heads would read another rank's
    KV group; the heads are gathered and the op runs local to its batch
    rows."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    q, k, v = _attn(np.random.RandomState(4), H=4, KV=2)
    heads = [Shard(0), Shard(2)]
    dq, dk, dv = (_placed(mesh, t, heads) for t in (q, k, v))
    with CommDebugMode() as comm:
        out = fa.flash_attention(dq, dk, dv)
    assert out.placements == (Shard(0), Replicate())
    assert comm.get_total_counts() == 3  # q, k and v gathered over "model"


def test_wrappers_trace_fake_card_tensors():
    """Under FakeTensorMode, fake CUDA tensors (the card's step traced
    without a card) go through the custom ops' fakes: the shapes and
    dtypes the kernels give, FLOPs counted by their formulas, no launch
    and no build."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = (rg.rme_assemble.launches, fa.flash_attention.launches,
              fa.flash_decode.launches)
    with FakeTensorMode(), FlopCounterMode(display=False) as flops:
        q = torch.empty(2, 64, 8, 16, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(2, 64, 2, 16, dtype=torch.bfloat16, device="cuda")
        x = torch.empty(6, 40, 3, device="cuda")
        mask = torch.empty(6, 40, dtype=torch.bool, device="cuda")
        q1 = torch.empty(2, 1, 8, 16, dtype=torch.bfloat16, device="cuda")
        pre = fa.flash_attention(q, kv, kv)
        dec = fa.flash_decode(q1, kv, kv, 9)
        rows, cnt = rg.rme_assemble(x, mask, 12)
    assert pre.shape == q.shape and pre.dtype == torch.bfloat16
    assert dec.shape == (2, 1, 8, 16) and dec.device.type == "cuda"
    assert rows.shape == (6, 12, 3) and cnt.shape == (6,)
    assert cnt.dtype == torch.int32
    assert flops.get_total_flops() == 4 * 2 * 8 * 16 * (64 * 64 + 64)
    assert (rg.rme_assemble.launches, fa.flash_attention.launches,
            fa.flash_decode.launches) == before
