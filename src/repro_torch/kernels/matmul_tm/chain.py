"""Cross-engine megakernels — a TM chain streamed through a compute kernel.

The epilogues of :mod:`repro_torch.kernels.matmul_tm.matmul_tm`
(transpose, pixel shuffle, split) forward three fixed manipulations at the
engine boundary.  This module generalizes them to ANY legal chain the
pullback plan of :mod:`repro_torch.kernels.tm_affine.chain` expresses, in
both directions, for a 2D product (``aten.mm``) or the models' NHWC
convolution (``repro_torch::conv2d_nhwc``):

* **compute→TM** (``cuda.xchain.commit``, :func:`xchain_commit`): the
  implicit-GEMM core of ``csrc/igemm.cuh`` computes the product's tiles,
  rounded once to the element type, into a scratch tensor (the Pallas
  kernel's VMEM slab), a grid-wide barrier follows, and then the chain
  walks its pullback from each of its output elements into that scratch
  (``csrc/xchain_commit.cu``, one cooperative launch);
* **TM→compute** (``cuda.xchain.prologue``, :func:`xchain_prologue`): the
  same two phases in the other order — the chain walks its pullback from
  the chain's sources into a scratch tensor in the crossing operand's
  layout (the Pallas kernel's VMEM buffer), a grid-wide barrier follows,
  and then the same core computes the product over it
  (``csrc/xchain_prologue.cu``, one cooperative launch).

Both are ONE launch, each beside its plain
PyTorch version (:func:`xchain_commit_plain`, :func:`xchain_prologue_plain`:
the op, then the chain's plain walk, or the reverse).  The registry rule
:func:`_xengine_lower` declines what the plan cannot take, and — for
lowering parity with the JAX package — a crossing whose operands, pullback
constants and staged crossing buffer would not fit its 128 MiB VMEM budget;
the caller then runs the split path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.compiler.ir import itemsize
from repro_torch.core.dispatch import register_xengine_rule
from repro_torch.core.fusion import XENGINE_PRIMS
from repro_torch.core.schedule import plan_segments
from repro_torch.kernels import build
from repro_torch.kernels.img2col.img2col import (CONV_PATHS, ConvPlan,
                                                 card_plan, conv_tma_ok)
from repro_torch.kernels.matmul_tm.matmul_tm import _product
from repro_torch.kernels.tm_affine.chain import (CHAIN_VMEM_BUDGET,
                                                 MAX_EXTRAS, MAX_LEVELS,
                                                 ChainSig, _device_consts,
                                                 build_chain_plan,
                                                 chain_plain)
from repro_torch.kernels.tm_affine.tm_affine import DTYPE_CODES
from repro_torch.models.cnn import conv2d_nhwc, conv_out_hw


@dataclasses.dataclass(frozen=True)
class Gemm:
    """The compute op as an implicit GEMM, out[m, n] = sum_k A(m, k) B(k, n)
    (``csrc/igemm.cuh``): ``mm`` of x (M, K) by w (K, N), or ``conv`` of
    an NHWC x by HWIO w with ``stride`` and ``padding`` (SAME or VALID)."""

    kind: str
    x_shape: tuple[int, ...]
    w_shape: tuple[int, ...]
    stride: int = 1
    padding: str = "VALID"

    @property
    def out_shape(self) -> tuple[int, ...]:
        if self.kind == "mm":
            return (self.x_shape[0], self.w_shape[1])
        B, H, W, _ = self.x_shape
        OH, OW, _, _ = conv_out_hw(H, W, self.w_shape[0], self.w_shape[1],
                                   self.stride, self.padding)
        return (B, OH, OW, self.w_shape[3])

    def words(self) -> list[int]:
        """The kernel's geometry table: kind, M, N, K, ldb, col0, then the
        conv's B, H, W, C, OH, OW, kh, kw, stride, pad top, pad left.  A
        1x1 conv of stride 1 is its mm, (B H W, C) x (C, OC), the same sums
        in the same order: TMA then fetches it in 2-d boxes, not in
        im2col mode."""
        if self.kind == "mm":
            (M, K), N = self.x_shape, self.w_shape[1]
            return [0, M, N, K, N, 0] + [0] * 11
        B, H, W, C = self.x_shape
        kh, kw, _, OC = self.w_shape
        OH, OW, pt, pl = conv_out_hw(H, W, kh, kw, self.stride, self.padding)
        if (kh, kw, self.stride, OH, OW) == (1, 1, 1, H, W):
            return [0, B * H * W, OC, C, OC, 0] + [0] * 11
        return [1, B * OH * OW, OC, kh * kw * C, OC, 0, B, H, W, C, OH, OW,
                kh, kw, self.stride, pt, pl]

    def flops(self) -> int:
        w = self.words()
        return 2 * w[1] * w[2] * w[3]


def gemm_of(node) -> Gemm | None:
    """The geometry of a compiler compute node, or None when its operands
    are not two tensors of the op's ranks."""
    if len(node.in_avals) != 2:
        return None
    (xs, _), (ws, _) = node.in_avals
    if node.op_name == "aten::mm" and len(xs) == 2 and len(ws) == 2:
        return Gemm("mm", tuple(xs), tuple(ws))
    if node.op_name == "repro_torch::conv2d_nhwc" and len(xs) == 4 \
            and len(ws) == 4 and len(node.args) == 4:
        return Gemm("conv", tuple(xs), tuple(ws), int(node.args[2]),
                    str(node.args[3]))
    return None


def op_plain(g: Gemm, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The compute op itself: the 2D product (f32 accumulation, integers
    exact and wrapped), or the NHWC conv custom op (floats; cuDNN, in TF32
    where ``torch.backends.cudnn.allow_tf32`` lets it) — for integers the
    same product over the conv's patch matrix."""
    if g.kind == "mm":
        return _product(x, w)
    if x.dtype.is_floating_point:
        return conv2d_nhwc(x, w, g.stride, g.padding)
    from repro_torch.core.affine import img2col_map
    from repro_torch.core.engine import apply_map
    B, H, W, C = g.x_shape
    kh, kw, _, OC = g.w_shape
    OH, OW, pt, pl = conv_out_hw(H, W, kh, kw, g.stride, g.padding)
    # pad (or crop) the far sides to exactly the windows' extent, then
    # img2col without padding
    hp = (OH - 1) * g.stride + kh - H - pt
    wp = (OW - 1) * g.stride + kw - W - pl
    xp = torch.nn.functional.pad(x, (0, 0, pl, wp, pt, hp))
    m = img2col_map(tuple(xp.shape[1:]), kh, kw, g.stride, 0)
    patches = apply_map(m, xp, batch_dims=1).reshape(B * OH * OW, -1)
    return _product(patches, w.reshape(kh * kw * C, OC)).reshape(
        B, OH, OW, OC)


# ---------------------------------------------------------------------------
# compute -> TM: the commit kernel
# ---------------------------------------------------------------------------

def xchain_commit_plain(sig: ChainSig, g: Gemm, x: torch.Tensor,
                        w: torch.Tensor,
                        slabs: tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """Plain version of the commit kernel: the op, then the chain."""
    return chain_plain(op_plain(g, x, w), build_chain_plan(sig), slabs)


def _table(sig: ChainSig, device, slabs) -> tuple:
    plan = build_chain_plan(sig)
    if len(plan.levels) > MAX_LEVELS or len(plan.extras) > MAX_EXTRAS:
        raise ValueError(f"xchain: the kernel takes at most {MAX_LEVELS} "
                         f"levels and {MAX_EXTRAS} extra Route bands")
    consts = _device_consts(sig, device)
    desc = list(consts.desc)
    for at, s in zip(consts.slab_at, slabs):
        desc[at] = s.data_ptr()
    return ((ctypes.c_int64 * len(desc))(*desc), len(plan.levels),
            len(plan.extras))


def _check(name: str, sig: ChainSig, g: Gemm, ops, slabs) -> None:
    ops = list(ops)
    dev = ops[0].device
    if not ops[0].is_cuda:
        raise ValueError(f"{name}: operands must be CUDA tensors, got {dev}")
    if ops[0].dtype not in DTYPE_CODES \
            or str(ops[0].dtype) != f"torch.{sig.dtype}":
        raise TypeError(f"{name}: dtype {ops[0].dtype} does not match the "
                        f"chain's {sig.dtype}")
    for t in ops + list(slabs):
        if t.device != dev or t.dtype != ops[0].dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: operands and slabs must be contiguous "
                             f"{ops[0].dtype} tensors on {dev}")


def _commit_geometry(g: Gemm) -> tuple[int, int, int, int | None, int]:
    """(M, N, K, C, taps) of the product: C None for an mm (or a 1x1
    conv run as its mm)."""
    w = g.words()
    if w[0] == 0:
        return w[1], w[2], w[3], None, 1
    return w[1], w[2], w[3], w[9], w[12] * w[13]


def _commit_tma_ok(g: Gemm, x: torch.Tensor) -> bool:
    """Whether TMA can fetch the product's A: 2-d boxes of an mm's rows
    (a 16-byte aligned x with rows a multiple of 16 bytes), or a conv's
    patches in im2col mode (:func:`conv_tma_ok`)."""
    w = g.words()
    if w[0] == 0:
        K = w[3]
        return (K >= 1 and (K * x.element_size()) % 16 == 0
                and x.data_ptr() % 16 == 0)
    _, _, _, _, _, _, _, H, W, C, OH, OW, _, _, stride, pt, pl = w
    return conv_tma_ok(x, C, H, W, OH, OW, stride, pt, pl)


def xchain_commit(sig: ChainSig, g: Gemm, x: torch.Tensor, w: torch.Tensor,
                  slabs: tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """The op ``g`` of x and w through the chain ``sig`` (the chain's
    source is the op's output), in one launch.  CPU tensor: the plain
    version; CUDA tensor: the kernel, or an exception."""
    if x.device.type == "cpu":
        return xchain_commit_plain(sig, g, x, w, slabs)
    lib = build.library("xchain_commit")  # a kernel that cannot be built raises
    _check("xchain_commit", sig, g, (x, w), slabs)
    if (tuple(x.shape), tuple(w.shape)) != (g.x_shape, g.w_shape) \
            or tuple(sig.links[0][0].in_shape) != g.out_shape:
        raise ValueError("xchain_commit: operand shapes do not match the "
                         "op, or the op's output not the chain's source")
    out = torch.empty(sig.out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch_commit(lib, sig, g, x, w, slabs, out, phases=3)
    xchain_commit.launches += 1
    return out


def _launch_commit(lib, sig, g, x, w, slabs, out, *, phases: int) -> None:
    """One launch of the commit kernel: ``phases`` 3 both, 1 the product
    phase alone, 2 the chain phase alone.  The product goes to a scratch
    (M, N) tensor in x's dtype, the Pallas kernel's VMEM slab."""
    table, n_levels, n_extras = _table(sig, x.device, slabs)
    gemm = (ctypes.c_int64 * 17)(*g.words())
    M, N = g.words()[1:3]
    plan = xchain_commit_card_plan(g, x)
    scratch = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = lib.xchain_commit(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                           scratch.data_ptr(), table, gemm,
                           DTYPE_CODES[x.dtype], out.numel(), n_levels,
                           n_extras, CONV_PATHS[plan.path], plan.BM, plan.BN,
                           plan.nct, plan.stages, plan.blocks_per_sm,
                           plan.grid, phases,
                           torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "xchain_commit")


def xchain_commit_card_plan(g: Gemm, x: torch.Tensor) -> ConvPlan:
    """The plan :func:`xchain_commit` launches with for this CUDA x: the
    product's :func:`conv_plan` on the card.  The launch is cooperative, so
    its grid, at most the blocks an SM holds times the SMs, is co-resident,
    which the grid-wide barrier between the phases needs."""
    lib = build.library("xchain_commit")
    M, N, K, C, taps = _commit_geometry(g)
    return card_plan(lib, "xchain_commit", x, M, N, K,
                     tma=_commit_tma_ok(g, x), C=C, taps=taps)


def xchain_commit_phase(sig: ChainSig, g: Gemm, x: torch.Tensor,
                        w: torch.Tensor, phase: str,
                        slabs: tuple[torch.Tensor, ...] = ()) -> None:
    """One phase of the commit kernel, for timing the split between them:
    ``product`` (the product into the scratch, then the grid-wide barrier)
    or ``chain`` (the barrier, then the chain over whatever the scratch
    holds).  Its output is not the commit's, and no launch is counted."""
    lib = build.library("xchain_commit")
    _check("xchain_commit", sig, g, (x, w), slabs)
    out = torch.empty(sig.out_shape, dtype=x.dtype, device=x.device)
    _launch_commit(lib, sig, g, x, w, slabs, out,
                   phases={"product": 1, "chain": 2}[phase])


xchain_commit.launches = 0


# ---------------------------------------------------------------------------
# TM -> compute: the prologue kernel
# ---------------------------------------------------------------------------

def xchain_prologue_plain(sig: ChainSig, g: Gemm, cross_pos: int,
                          src: torch.Tensor, other: torch.Tensor,
                          slabs: tuple[torch.Tensor, ...] = ()
                          ) -> torch.Tensor:
    """Plain version of the prologue kernel: the chain, then the op with
    the chain's output as operand ``cross_pos`` (0: x, 1: w)."""
    xc = chain_plain(src, build_chain_plan(sig), slabs)
    return op_plain(g, *((xc, other) if cross_pos == 0 else (other, xc)))


def xchain_prologue(sig: ChainSig, g: Gemm, cross_pos: int,
                    src: torch.Tensor, other: torch.Tensor,
                    slabs: tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """The op ``g`` whose operand ``cross_pos`` is the output of the chain
    ``sig`` over ``src`` and whose other operand is ``other``, in one
    launch.  CPU tensor: the plain version; CUDA tensor: the kernel, or an
    exception."""
    if src.device.type == "cpu":
        return xchain_prologue_plain(sig, g, cross_pos, src, other, slabs)
    lib = build.library("xchain_prologue")  # a failed build raises here
    _check_prologue(sig, g, cross_pos, src, other, slabs)
    out = torch.empty(g.out_shape, dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    _launch_prologue(lib, sig, g, cross_pos, src, other, slabs, out,
                     phases=3)
    xchain_prologue.launches += 1
    return out


def _check_prologue(sig, g, cross_pos, src, other, slabs) -> None:
    _check("xchain_prologue", sig, g, (src, other), slabs)
    shapes = (g.x_shape, g.w_shape)
    if (cross_pos not in (0, 1)
            or tuple(sig.out_shape) != shapes[cross_pos]
            or tuple(other.shape) != shapes[1 - cross_pos]
            or tuple(src.shape) != tuple(sig.links[0][0].in_shape)):
        raise ValueError("xchain_prologue: the chain's output is not operand "
                         f"{cross_pos} of the op, or shapes do not match")


def _launch_prologue(lib, sig, g, cross_pos, src, other, slabs, out, *,
                     phases: int) -> None:
    """One launch of the prologue kernel: ``phases`` 3 both, 1 the chain
    phase alone, 2 the product phase alone.  The chain writes a scratch
    tensor of the crossing operand's shape (the Pallas kernel's VMEM
    buffer), which the product then reads as that operand; ``place_of``
    the SM of each block, where the kernel spreads fewer tiles than blocks
    over the SMs."""
    table, n_levels, n_extras = _table(sig, src.device, slabs)
    gemm = (ctypes.c_int64 * 17)(*g.words())
    scratch = torch.empty(sig.out_shape, dtype=src.dtype, device=src.device)
    plan = xchain_prologue_card_plan(g, scratch if cross_pos == 0 else other)
    place_of = torch.empty(plan.grid, dtype=torch.int32, device=src.device)
    rc = lib.xchain_prologue(src.data_ptr(), other.data_ptr(), out.data_ptr(),
                             scratch.data_ptr(), place_of.data_ptr(), table,
                             gemm,
                             DTYPE_CODES[src.dtype], cross_pos,
                             scratch.numel(), n_levels, n_extras,
                             CONV_PATHS[plan.path], plan.BM, plan.BN,
                             plan.nct, plan.stages, plan.blocks_per_sm,
                             plan.grid, phases,
                             torch.cuda.current_stream(src.device).cuda_stream)
    build.check(rc, "xchain_prologue")


def xchain_prologue_card_plan(g: Gemm, a: torch.Tensor) -> ConvPlan:
    """The plan :func:`xchain_prologue` launches with, ``a`` the product's
    A operand on the card: the scratch the chain fills (``cross_pos`` 0) or
    x (1).  It is the product's :func:`conv_plan`, as the commit's
    (:func:`xchain_commit_card_plan`): TMA where it can take ``a`` and the
    blocks an SM holds of the prologue kernel; its cooperative grid is
    :func:`prologue_grid`, as large as the card holds at once, which the
    grid-wide barrier between the phases needs."""
    lib = build.library("xchain_prologue")
    M, N, K, C, taps = _commit_geometry(g)
    return prologue_grid(card_plan(lib, "xchain_prologue", a, M, N, K,
                                   tma=_commit_tma_ok(g, a), C=C,
                                   taps=taps))


def prologue_grid(plan: ConvPlan) -> ConvPlan:
    """The prologue's grid: every block the card holds at once (blocks an
    SM x SMs), not only one per tile, so that the chain phase runs on all
    of them; where there are fewer tiles, the kernel gives them to blocks
    on distinct SMs first (``igemm::tile_place``), and the rest have no
    product tile."""
    return dataclasses.replace(plan, grid=plan.blocks_per_sm * plan.sms)


def xchain_prologue_phase(sig: ChainSig, g: Gemm, cross_pos: int,
                          src: torch.Tensor, other: torch.Tensor, phase: str,
                          slabs: tuple[torch.Tensor, ...] = ()) -> None:
    """One phase of the prologue kernel, for timing the split between
    them: ``chain`` (the walk into the scratch, then the grid-wide barrier)
    or ``product`` (the barrier, then the product over whatever the
    scratch holds).  Its output is not the prologue's, and no launch is
    counted."""
    lib = build.library("xchain_prologue")
    _check_prologue(sig, g, cross_pos, src, other, slabs)
    out = torch.empty(g.out_shape, dtype=src.dtype, device=src.device)
    _launch_prologue(lib, sig, g, cross_pos, src, other, slabs, out,
                     phases={"chain": 1, "product": 2}[phase])


xchain_prologue.launches = 0


# ---------------------------------------------------------------------------
# the registry rule
# ---------------------------------------------------------------------------

def _is_tensor(a) -> bool:
    return isinstance(a, torch.Tensor) and a.ndim >= 1


def budget_bytes(sig: ChainSig, eqn_srcs, slabs, staged_elems: int,
                 staged_itemsize: int) -> int:
    """The JAX package's VMEM residency estimate of a crossing: the op's
    operands, the chain's slabs, its int32 pullback constants and the
    staged crossing buffer (``matmul_tm/chain.py:_budget_bytes``)."""
    n = sum(a.numel() * a.element_size() for a in eqn_srcs if a is not None)
    for s in slabs:
        n += s.numel() * s.element_size()
    n += 4 * math.prod(sig.out_shape) * (1 + len(sig.links))
    n += staged_elems * staged_itemsize
    return n


def _decline(reasons, why: str):
    if reasons is not None:
        reasons.append(why)
    return None


def _xengine_lower(direction, eqn_node, eqn_srcs, instrs, tm_srcs,
                   segment_bytes=None, reasons=None):
    """Single-pass cross-engine lowering: legality + build + run, or None.
    A claimed crossing on a CUDA tensor launches its kernel or raises."""
    from repro_torch.kernels.tm_affine.ops import _chain_sig_build

    if eqn_node.op_name not in XENGINE_PRIMS \
            or len(eqn_node.dst_names) != 1:
        return _decline(reasons, f"{eqn_node.op_name} is no xchain op")
    g = gemm_of(eqn_node)
    if g is None:
        return _decline(reasons, "operands are not the op's two tensors")
    y_shape, y_dtype = eqn_node.out_avals[0]

    if direction == "compute_to_tm":
        if any(not _is_tensor(a) or a.dtype != y_dtype for a in eqn_srcs):
            return _decline(reasons, "operands of another dtype")
        stand_in = torch.empty(y_shape, dtype=y_dtype, device="meta")
        srcs = [list(s) for s in tm_srcs]
        if not srcs or srcs[0][0] is not None:
            return _decline(reasons, "the chain does not read the product")
        srcs[0][0] = stand_in
        sig, slabs = _chain_sig_build(instrs, srcs, 0, segment_bytes)
        if sig is None:
            return _decline(reasons, "the chain plan cannot take the run")
        need = budget_bytes(sig, eqn_srcs, slabs, stand_in.numel(),
                            itemsize(y_dtype))
        if need > CHAIN_VMEM_BUDGET:
            return _decline(reasons, f"{need / 1e6:.1f} MB over the "
                                     f"{CHAIN_VMEM_BUDGET >> 20} MiB budget")
        plan = build_chain_plan(sig)
        # the product's row blocks as the JAX package's commit grid counts
        # them: the first chain segment runs in the last compute step
        nc = (plan_segments(tuple(y_shape), itemsize(y_dtype),
                            sig.segment_bytes).n_segments
              if g.kind == "mm" and g.x_shape[0] > 1 else 1)
        x, w = eqn_srcs
        val = xchain_commit(sig, g, x.contiguous(), w.contiguous(),
                            tuple(s.contiguous() for s in slabs))
        return val, "cuda.xchain.commit", nc - 1 + plan.n_segments

    if direction == "tm_to_compute":
        cross = [i for i, a in enumerate(eqn_srcs) if a is None]
        if len(cross) != 1:
            return _decline(reasons, "no single crossing operand")
        cross_pos = cross[0]
        other = eqn_srcs[1 - cross_pos]
        if not _is_tensor(other) or other.dtype != y_dtype:
            return _decline(reasons, "operands of another dtype")
        if not tm_srcs or not tm_srcs[0] or tm_srcs[0][0] is None:
            return _decline(reasons, "the chain has no source")
        sig, slabs = _chain_sig_build(instrs, tm_srcs, 0, segment_bytes)
        if sig is None:
            return _decline(reasons, "the chain plan cannot take the run")
        a_shape, a_dtype = eqn_node.in_avals[cross_pos]
        if tuple(a_shape) != tuple(sig.out_shape) \
                or a_dtype != getattr(torch, sig.dtype):
            return _decline(reasons, "the chain's output is not the operand")
        x = tm_srcs[0][0]
        need = budget_bytes(sig, [x, other], slabs,
                            math.prod(sig.out_shape), itemsize(a_dtype))
        if need > CHAIN_VMEM_BUDGET:
            return _decline(reasons, f"{need / 1e6:.1f} MB over the "
                                     f"{CHAIN_VMEM_BUDGET >> 20} MiB budget")
        val = xchain_prologue(sig, g, cross_pos, x.contiguous(),
                              other.contiguous(),
                              tuple(s.contiguous() for s in slabs))
        return val, "cuda.xchain.prologue", build_chain_plan(sig).n_segments

    return _decline(reasons, f"unknown direction {direction!r}")


register_xengine_rule("matmul_tm.xchain", _xengine_lower, priority=0)
