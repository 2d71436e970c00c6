"""Where ``softmax_xent``'s logits live decides its pass: CPU and meta
logits, and DTensors whose shards lie there, take the plain version (the
eager f32 chain the loss always ran, bit for bit); card tensors and card
DTensors the kernels of ``csrc/xent.cu``, a DTensor's on each rank's shard,
with the partial form where the vocabulary is split over ranks.  The
kernels run only on the card (``tests/test_torch_gpu.py`` holds them
against the plain version); here the wiring around them runs with a
PyTorch mirror of each kernel in their place, on one rank and on a real
four-rank ``gloo`` mesh."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.fp_bounds import ulps_apart
from repro_torch.kernels import xent
from repro_torch.models.layers import softmax_xent

DTYPES = (torch.bfloat16, torch.float32)


def _parent_softmax_xent(logits, labels, ignore_id=-1):
    """``softmax_xent`` as it was before the kernels, op for op: the bits
    the plain path keeps."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None]
                        .to(torch.int64))
    nll = (lse[..., None] - gold)[..., 0]
    valid = (labels != ignore_id).float()
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _case(seed, dtype, B=2, S=5, V=37, ignored=(1, 7)):
    """(logits (B, S, V), labels (B, S)) from ``seed``, the positions in
    ``ignored`` (flat) at the ignore id -1."""
    rng = np.random.RandomState(seed)
    logits = torch.tensor(rng.randn(B, S, V).astype(np.float32) * 3)
    labels = torch.tensor(rng.randint(0, V, size=(B, S)), dtype=torch.int64)
    labels.view(-1)[list(ignored)] = -1
    return logits.to(dtype), labels


def _loss_and_grad(fn, logits, labels):
    x = logits.detach().clone().requires_grad_()
    loss = fn(x, labels)
    (grad,) = torch.autograd.grad(loss, [x])
    return loss.detach(), grad


def _launches():
    return xent.xent_rows.launches, xent.xent_grad.launches


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ignored", [(), (1, 7), tuple(range(10))])
def test_cpu_logits_take_the_plain_path_bit_for_bit(dtype, ignored):
    """CPU logits: the loss and its gradient the parent's bit for bit, no
    kernel asked for; some and all positions ignored."""
    logits, labels = _case(0, dtype, ignored=ignored)
    before = _launches()
    got = _loss_and_grad(softmax_xent, logits, labels)
    want = _loss_and_grad(_parent_softmax_xent, logits, labels)
    assert _launches() == before
    assert not xent.on_card(logits)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_meta_logits_take_the_plain_path():
    """The dry-run's logits are meta tensors: the plain version traces
    them, forward and backward, and no kernel is asked for."""
    logits, labels = _case(1, torch.bfloat16)
    logits, labels = logits.to("meta"), labels.to("meta")
    before = _launches()
    loss, grad = _loss_and_grad(softmax_xent, logits, labels)
    assert _launches() == before
    assert not xent.on_card(logits)
    assert loss.device.type == "meta" and loss.shape == ()
    assert grad.device.type == "meta" and grad.dtype == torch.bfloat16
    assert grad.shape == logits.shape


@pytest.fixture
def mesh():
    """A (1,) "cpu" mesh over a one-rank gloo group in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dim", [0, 2])
def test_dtensor_logits_take_the_plain_path_bit_for_bit(mesh, dim):
    """DTensor logits, sharded over the batch or the vocabulary: the loss
    and its gradient the parent's on the same DTensors bit for bit, and
    ``xent/rows`` counts this rank's positions."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor

    logits, labels = _case(2, torch.float32)
    dl = distribute_tensor(logits, mesh, [Shard(dim)])
    dlab = distribute_tensor(labels, mesh, [Shard(0) if dim == 0
                                            else Replicate()])
    assert not xent.on_card(dl)
    before = _launches()
    tr = obs.Tracer()
    with obs.use(tr):
        got = _loss_and_grad(softmax_xent, dl, dlab)
    want = _loss_and_grad(_parent_softmax_xent, dl, dlab)
    assert _launches() == before
    assert tr.counters() == {"xent/rows": labels.numel()}
    for a, b in zip(got, want):
        assert isinstance(a, DTensor) and isinstance(b, DTensor)
        assert torch.equal(a.full_tensor(), b.full_tensor())


def mirror_rows(logits, labels, col0, vocab, whole):
    """``xent._rows`` in PyTorch: ``(nll or None, max, sum, gold or
    None)`` of the columns ``[col0, col0 + V)``."""
    x = logits.float()
    m = x.amax(-1)
    s = torch.exp(x - m[:, None]).sum(-1)
    c = labels.clamp(min=0) - col0
    held = (c >= 0) & (c < x.shape[1])
    gold = torch.where(held, x.gather(-1, c.clamp(0, x.shape[1] - 1)[:, None])
                       [:, 0], 0.0)
    return ((m + torch.log(s)) - gold if whole else None, m, s,
            None if whole else gold)


def mirror_grad(logits, labels, mx, sm, dnll, col0=0, vocab=None):
    """``xent.xent_grad`` in PyTorch."""
    g = (dnll / sm)[:, None] * torch.exp(logits.float() - mx[:, None])
    c = labels.clamp(min=0) - col0
    held = (c >= 0) & (c < g.shape[1])
    g[held.nonzero()[:, 0], c[held]] -= dnll[held]
    return torch.where(dnll[:, None] == 0, 0.0, g).to(logits.dtype)


def install_mirrors(setattr_):
    """Card logits in name: ``on_card`` says yes and each kernel is its
    mirror, installed with ``setattr_(module, name, value)``; returns the
    calls made with their arguments."""
    calls = []

    def rows(logits, labels, col0, vocab, whole):
        calls.append(("rows", logits, labels, col0, vocab, whole))
        return mirror_rows(logits, labels, col0, vocab, whole)

    def grad(logits, labels, mx, sm, dnll, col0=0, vocab=None):
        calls.append(("grad", logits, labels, dnll, col0, vocab))
        return mirror_grad(logits, labels, mx, sm, dnll, col0, vocab)

    setattr_(xent, "on_card", lambda logits: True)
    setattr_(xent, "_rows", rows)
    setattr_(xent, "xent_grad", grad)
    return calls


def _mirror(monkeypatch):
    return install_mirrors(monkeypatch.setattr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_card_path_hands_the_kernels_rows_and_the_mean_through_dnll(
        monkeypatch, dtype):
    """With the kernels mirrored: one call of each over the (B S, V) rows
    and int64 labels; the gradient of the mean reaches the gradient
    kernel as ``dnll`` = 1 / (valid positions) on valid rows and 0 on
    ignored ones; the loss within 1e-6 of the plain one and the gradient
    within one bf16 ulp (the plain chain adds its amax branch's rounding
    at each row's max); both counters."""
    logits, labels = _case(3, dtype, V=40)
    calls = _mirror(monkeypatch)
    tr = obs.Tracer()
    with obs.use(tr):
        loss, grad = _loss_and_grad(softmax_xent, logits, labels)
    assert [c[0] for c in calls] == ["rows", "grad"]
    (_, rl, rlab, *rcols), (_, gl, glab, dnll, *gcols) = calls
    assert rcols == [0, 40, True] and gcols == [0, None]
    assert rl.shape == gl.shape == (10, 40) and rl.dtype == dtype
    assert rlab.dtype == torch.int64 and torch.equal(rlab, labels.view(-1))
    valid = labels.view(-1) != -1
    assert dnll.dtype == torch.float32 and dnll.shape == (10,)
    assert torch.equal(dnll, valid.float() / valid.sum())
    assert tr.counters() == {"xent/rows": 10, "xent/kernel_rows": 10}
    want_loss, want_grad = _loss_and_grad(_parent_softmax_xent, logits,
                                          labels)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert grad.dtype == dtype and grad.shape == logits.shape
    assert torch.equal(grad[~valid.view(2, 5)],
                       torch.zeros_like(grad[~valid.view(2, 5)]))
    assert int(ulps_apart(grad.to(torch.bfloat16),
                          want_grad.to(torch.bfloat16)).max()) <= 1


def test_untraced_loss_counts_nothing(monkeypatch):
    """Outside a tracer the null tracer counts nothing on either path."""
    logits, labels = _case(4, torch.float32, V=40)
    tr = obs.Tracer()
    softmax_xent(logits, labels)
    _mirror(monkeypatch)
    softmax_xent(logits, labels)
    assert tr.counters() == {}
    assert obs.current() is obs.NULL_TRACER


@pytest.mark.parametrize("bad", ["float16", "float64", "strided", "ragged"])
def test_card_path_refuses_what_the_kernels_do_not_take(monkeypatch, bad):
    """Logits the kernels do not take raise on the card path: another
    dtype, a strided last dimension, a row that is not whole vectors of 8
    (V = 37); no fallback to the plain version, no launch."""
    logits, labels = _case(5, torch.float32, V=37 if bad == "ragged" else 40)
    if bad == "strided":
        logits = logits.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad != "ragged":
        logits = logits.to(getattr(torch, bad))
    monkeypatch.setattr(xent, "on_card", lambda logits: True)
    before = _launches()
    with pytest.raises(TypeError if bad.startswith("float") else ValueError,
                       match="dtype" if bad.startswith("float") else
                       "contiguous and a multiple of 8"):
        softmax_xent(logits.requires_grad_(), labels)
    assert _launches() == before


def test_wrappers_refuse_cpu_tensors_before_building():
    """The wrappers check their operands before the library is built: CPU
    logits raise here, where no compiler is needed."""
    logits, labels = _case(6, torch.bfloat16, V=40)
    rows = torch.zeros(10)
    with pytest.raises(ValueError, match="CUDA"):
        xent.xent_rows(logits.view(10, 40), labels.view(-1))
    with pytest.raises(ValueError, match="CUDA"):
        xent.xent_rows_part(logits.view(10, 40), labels.view(-1), 40, 80)
    with pytest.raises(ValueError, match="CUDA"):
        xent.xent_grad(logits.view(10, 40), labels.view(-1), rows, rows,
                       rows)
    with pytest.raises(ValueError, match="rows"):
        xent.xent_rows(logits, labels)


@pytest.mark.parametrize("place", ["rows", "vocab", "replicated"])
def test_card_dtensor_takes_the_kernels_on_its_shard(mesh, monkeypatch,
                                                     place):
    """Card DTensor logits (the kernels mirrored) on a one-rank mesh: one
    whole-row launch of each kernel on the rank's shard, whatever the
    placement, since no rank holds less than the whole vocabulary; the
    loss and the gradient the plain card tensor's bit for bit; both
    counters."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    logits, labels = _case(7, torch.bfloat16, V=40)
    calls = _mirror(monkeypatch)
    want = _loss_and_grad(softmax_xent, logits, labels)
    calls.clear()
    placement = {"rows": Shard(0), "vocab": Shard(2),
                 "replicated": Replicate()}[place]
    dl = distribute_tensor(logits, mesh, [placement])
    dlab = distribute_tensor(labels, mesh, [Shard(0) if place == "rows"
                                            else Replicate()])
    tr = obs.Tracer()
    with obs.use(tr):
        got = _loss_and_grad(softmax_xent, dl, dlab)
    assert [(c[0], c[-2:]) for c in calls] == [("rows", (40, True)),
                                                ("grad", (0, None))]
    assert tr.counters() == {"xent/rows": 10, "xent/kernel_rows": 10}
    for a, b in zip(got, want):
        assert isinstance(a, DTensor)
        assert torch.equal(a.full_tensor(), b)


MESH_V = 48  # columns 24 a rank over two ranks, 12 over four

_WORKER = r"""
import os
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(os.path.join(out, "store"),
                                                 world))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    import test_torch_xent_dispatch as t
    from repro_torch import obs
    from repro_torch.models.layers import softmax_xent

    res = {}
    for name, dims, places in (("data_model", (2, 2), [Shard(0), Shard(2)]),
                               ("model", (1, 4), [Shard(0), Shard(2)])):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data",
                                                              "model"))
        logits, labels = t._case(8, torch.float32, B=4, S=3, V=t.MESH_V,
                                 ignored=(2,))
        # the gold columns on every rank's share, column 0 among them
        labels.view(-1)[:4] = torch.tensor([0, 12, 25, 47])
        calls = t.install_mirrors(lambda m, k, v: setattr(m, k, v))
        tr = obs.Tracer()
        with obs.use(tr):
            x = distribute_tensor(logits, mesh, places).requires_grad_()
            loss = softmax_xent(x, distribute_tensor(labels, mesh,
                                                     [Shard(0), Shard(0)]))
            grad, = torch.autograd.grad(loss, [x])
        seen = [(c[0], c[-3:] if c[0] == "rows" else c[-2:]) for c in calls]
        every = [None] * world
        dist.all_gather_object(every, (seen, tr.counters()))
        res[name] = dict(loss=loss.full_tensor().detach(),
                         grad=grad.full_tensor(),
                         logits=logits, labels=labels, calls=every)
    if rank == 0:
        with open(os.path.join(out, "results.pkl"), "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(4, sys.argv[1]), nprocs=4, join=True)
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The four workers' results: softmax_xent of card DTensors (the
    kernels mirrored) on a (2, 2) and a (1, 4) ("data", "model") gloo
    mesh, the batch over "data" and the vocabulary over "model"."""
    out = tmp_path_factory.mktemp("xent_mesh")
    script = out / "worker.py"
    script.write_text(_WORKER)
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, here, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, str(script), str(out)], env=env,
                   check=True, timeout=300)
    with open(out / "results.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", ["data_model", "model"])
def test_card_dtensor_vocab_split_over_ranks_combines(mesh_run, name):
    """A vocabulary split over "model": each rank one partial launch on
    its columns (its first column by ``torch.chunk``'s split, the whole
    vocabulary's width beside it) and one gradient launch with them; the
    loss within 1e-6 of the plain loss on the whole tensors and the
    gradient within 1e-7, the ranks' (max, sum, gold) combined over the
    ranks that share rows; each rank counts its own rows."""
    r = mesh_run[name]
    model = 2 if name == "data_model" else 4
    rows = 12 // (4 // model)
    chunk = -(-MESH_V // model)
    for rank, (seen, counters) in enumerate(r["calls"]):
        col0 = (rank % model) * chunk
        assert seen == [("rows", (col0, MESH_V, False)),
                        ("grad", (col0, MESH_V))], rank
        assert counters == {"xent/rows": rows, "xent/kernel_rows": rows}
    want_loss, want_grad = _loss_and_grad(_parent_softmax_xent,
                                          r["logits"], r["labels"])
    assert float(r["loss"]) == pytest.approx(float(want_loss), rel=1e-6)
    torch.testing.assert_close(r["grad"], want_grad, rtol=0, atol=1e-7)
