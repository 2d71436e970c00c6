"""Generic execution engine for the unified address abstraction.

``apply_map`` executes *any* :class:`~repro_torch.core.affine.MixedRadixMap`
on a tensor — the software model of the TMU's reconfigurable
address-generation datapath: one routine, parameterized by instruction fields
(splits / A / b / fill), executes every coarse-grained TM operator.  This is
the reference engine the kernels are held against, and the path an
instruction takes when no kernel rule claims it.

Exactness: affine rows with rational entries are evaluated as
``floor((Σ num_j·d_j + num_b) / L)`` with ``L`` the LCM of denominators —
bit-exact w.r.t. the Fraction oracle, including negative operands
(``torch.div(..., rounding_mode="floor")`` floors toward -inf like Python).
Indices are int64, so tensors of 2^31 or more elements address correctly.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.affine import MixedRadixMap
from repro_torch.core.spec import row_major_strides

# the element-wise stage's vector ops, keyed by EwOp.value — the single
# table shared by the reference executor and the kernels' plain versions
EW_FNS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
          "max": torch.maximum}


def _row_int_form(row, off) -> tuple[tuple[int, ...], int, int]:
    """(numerators, offset_numerator, common_denominator) for one affine row."""
    dens = [a.denominator for a in row] + [off.denominator]
    L = 1
    for d in dens:
        L = L * d // math.gcd(L, d)
    nums = tuple(int(a * L) for a in row)
    return nums, int(off * L), L


def gather_indices(m: MixedRadixMap, device=None,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat input index + validity mask for every output element.

    Returns ``(flat_idx, valid)`` of shape ``m.out_shape`` (int64 / bool) on
    ``device``.  Coordinates stay broadcastable views until the end, so the
    only full-size tensors are the two results."""
    nd_out = len(m.out_shape)
    coords = []
    for d, n in enumerate(m.out_shape):
        view = [1] * nd_out
        view[d] = n
        coords.append(torch.arange(n, dtype=torch.int64,
                                   device=device).reshape(view))
    # mixed-radix digit expansion (quotient in place, remainders appended)
    digits = list(coords)
    for sp in m.splits:
        q = torch.div(digits[sp.axis], sp.radix, rounding_mode="floor")
        digits.append(digits[sp.axis] - q * sp.radix)
        digits[sp.axis] = q
    # affine rows -> input coordinates (exact floor with common denominator)
    in_coords = []
    for row, off in zip(m.affine.A, m.affine.b):
        nums, offn, L = _row_int_form(row, off)
        acc = torch.full((1,) * nd_out, offn, dtype=torch.int64, device=device)
        for n, d in zip(nums, digits):
            if n != 0:
                acc = acc + n * d
        in_coords.append(acc if L == 1
                         else torch.div(acc, L, rounding_mode="floor"))
    valid = torch.ones((1,) * nd_out, dtype=torch.bool, device=device)
    for c, s in zip(in_coords, m.in_shape):
        valid = valid & (c >= 0) & (c < s)
    for d, bound in m.digit_bounds:
        valid = valid & (digits[d] < bound)
    flat = torch.zeros((1,) * nd_out, dtype=torch.int64, device=device)
    for c, s, st in zip(in_coords, m.in_shape, row_major_strides(m.in_shape)):
        flat = flat + torch.clamp(c, 0, s - 1) * st
    shape = tuple(m.out_shape)
    return (flat.expand(shape).contiguous(), valid.expand(shape).contiguous())


def apply_map(m: MixedRadixMap, x: torch.Tensor, *,
              batch_dims: int = 0) -> torch.Tensor:
    """Execute a gather map.  Leading ``batch_dims`` axes pass through."""
    if tuple(x.shape[batch_dims:]) != tuple(m.in_shape):
        raise ValueError(f"input shape {tuple(x.shape)} does not end in the "
                         f"map's in_shape {m.in_shape} (batch_dims="
                         f"{batch_dims})")
    flat, valid = gather_indices(m, x.device)
    batch = tuple(x.shape[:batch_dims])
    xf = x.reshape(batch + (-1,))
    out = xf.index_select(batch_dims, flat.reshape(-1))
    out = out.reshape(batch + tuple(m.out_shape))
    if m.oob_possible:
        fill = torch.tensor(m.fill, dtype=x.dtype, device=x.device)
        out = torch.where(valid, out, fill)
    return out


def route_gather(maps, xs, *, batch_dims: int = 0,
                 overlay: bool = False) -> torch.Tensor:
    """Multi-band gather (paper Route): each map reads its source into its
    band of the output; disjoint supports sum to the concat.

    ``overlay=True`` switches the combine from sum to *last-writer-wins*:
    each later band overwrites the output wherever its map is in-bounds.
    Bands may then overlap — the semantics of ``dynamic_update_slice``
    (base tensor + update window) rather than concatenate, and the floating
    point result is bit-exact because values are selected, never added."""
    out = None
    for x, m in zip(xs, maps):
        band = apply_map(m, x, batch_dims=batch_dims)
        if out is None:
            out = band
        elif overlay:
            _, valid = gather_indices(m, x.device)  # broadcasts over batch
            out = torch.where(valid, band, out)
        else:
            out = out + band
    return out


def scatter_accumulate(m: MixedRadixMap, x: torch.Tensor, out: torch.Tensor,
                       *, batch_dims: int = 0) -> torch.Tensor:
    """Scatter ``x`` (shaped ``m.out_shape``) into ``out`` via the map's
    *input* coordinates — the paper's scatter formulation, checked against
    the gather form.  Invalid positions keep ``out``'s value."""
    flat, valid = gather_indices(m, x.device)
    batch = tuple(out.shape[:batch_dims])
    outf = out.reshape(batch + (-1,))
    contrib = (torch.where(valid, x, torch.zeros_like(x)) if m.oob_possible
               else x)
    fl = flat.reshape(-1)
    va = valid.reshape(-1)
    xb = contrib.reshape(batch + (-1,))
    vals = torch.where(va, xb, outf.index_select(batch_dims, fl))
    res = outf.clone()
    res[(slice(None),) * batch_dims + (fl,)] = vals
    return res.reshape(out.shape)
