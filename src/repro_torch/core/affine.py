"""Unified Address Abstraction — the paper's Eq. 1 / Table II, TPU-native.

The TMU paper encodes every coarse-grained tensor-manipulation (TM) operator
as a pair of affine matrices ``(A, B)`` loaded into reconfigurable registers:
one shared address-generation datapath executes Transpose, Rot90, Img2col,
PixelShuffle, PixelUnshuffle, Upsample, Route, Split and Add by
re-parameterization alone (paper Table II).

This module is that abstraction, generalized exactly enough to be executable
on TPU:

* :class:`AffineMap` — an exact-rational affine map ``y = A @ x + b`` over
  integer index vectors (``fractions.Fraction`` entries, exact compose /
  inverse).  This is the paper's Eq. 1 verbatim.

* :class:`MixedRadixMap` — the *gather form* used by the execution engines.
  The paper's address generator iterates input coordinates and scatters to
  affinely-computed output addresses.  TPU-efficient kernels must instead
  compute each **output** tile from input tiles, so we store the exact
  inverse: output coordinates are first expanded into mixed-radix digits
  (``y -> (y // r, y % r)``) and the digit vector is mapped affinely to input
  coordinates.  Every Table II operator is *exactly* affine over such a digit
  expansion (e.g. PixelShuffle's channel de-interleave is affine over the
  ``s``-radix digits of the output spatial coordinates).  A new TM operator is
  a new ``MixedRadixMap`` — never a new datapath — which is the paper's
  reconfigurability claim, kept intact.

Scatter (paper) and gather (ours) forms are interconvertible where ``A`` is
invertible; both are retained, and tests check the round trip.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Sequence

Frac = Fraction


def _as_frac_matrix(rows: Sequence[Sequence]) -> tuple[tuple[Frac, ...], ...]:
    return tuple(tuple(Frac(v) for v in row) for row in rows)


def _as_frac_vector(vec: Sequence) -> tuple[Frac, ...]:
    return tuple(Frac(v) for v in vec)


def memoized_hash(obj, *fields) -> int:
    """Structural hash computed once per frozen instance.

    Maps are hashed constantly (kernel-cache lookups, jit static args) and
    Fraction.__hash__ is expensive (a modular pow per entry), so the frozen
    dataclasses cache their hash in ``__dict__`` on first use."""
    h = obj.__dict__.get("_hash")
    if h is None:
        h = hash(fields)
        object.__setattr__(obj, "_hash", h)
    return h


@dataclasses.dataclass(frozen=True)
class AffineMap:
    """Exact rational affine index map ``y = A @ x + b`` (paper Eq. 1).

    ``A`` is ``n_out x n_in``; entries are :class:`fractions.Fraction` so that
    the paper's ``1/s`` and ``1/x_s`` entries (PixelShuffle, Img2col, Split)
    are represented exactly.  ``apply`` floors the result, matching the
    hardware divider's truncation.
    """

    A: tuple[tuple[Frac, ...], ...]
    b: tuple[Frac, ...]

    def __hash__(self):
        return memoized_hash(self, self.A, self.b)

    # --- constructors -----------------------------------------------------
    @staticmethod
    def make(A: Sequence[Sequence], b: Sequence | None = None) -> "AffineMap":
        A_ = _as_frac_matrix(A)
        if b is None:
            b = [0] * len(A_)
        return AffineMap(A_, _as_frac_vector(b))

    @staticmethod
    def identity(n: int) -> "AffineMap":
        return AffineMap.make([[1 if i == j else 0 for j in range(n)] for i in range(n)])

    @staticmethod
    def permutation(perm: Sequence[int]) -> "AffineMap":
        """y[i] = x[perm[i]]."""
        n = len(perm)
        return AffineMap.make(
            [[1 if j == perm[i] else 0 for j in range(n)] for i in range(n)]
        )

    # --- shape ------------------------------------------------------------
    @property
    def n_out(self) -> int:
        return len(self.A)

    @property
    def n_in(self) -> int:
        return len(self.A[0]) if self.A else 0

    # --- evaluation -------------------------------------------------------
    def apply(self, x: Sequence[int]) -> tuple[int, ...]:
        """Exact evaluation with floor (hardware truncating divider)."""
        assert len(x) == self.n_in, (len(x), self.n_in)
        out = []
        for row, off in zip(self.A, self.b):
            acc = Frac(0)
            for a, xi in zip(row, x):
                acc += a * xi
            acc += off
            out.append(int(acc // 1))  # floor
        return tuple(out)

    def apply_exact(self, x: Sequence[int]) -> tuple[Frac, ...]:
        out = []
        for row, off in zip(self.A, self.b):
            acc = Frac(0)
            for a, xi in zip(row, x):
                acc += a * xi
            out.append(acc + off)
        return tuple(out)

    # --- algebra ----------------------------------------------------------
    def compose(self, inner: "AffineMap") -> "AffineMap":
        """self ∘ inner — exact when evaluated without intermediate floors.

        Fusion legality: exact for integer-valued intermediate results; the
        fusion pass checks :meth:`is_integral` of ``inner`` before composing.
        """
        assert self.n_in == inner.n_out, (self.n_in, inner.n_out)
        A = tuple(
            tuple(
                sum((self.A[i][k] * inner.A[k][j] for k in range(self.n_in)), Frac(0))
                for j in range(inner.n_in)
            )
            for i in range(self.n_out)
        )
        b = tuple(
            sum((self.A[i][k] * inner.b[k] for k in range(self.n_in)), Frac(0))
            + self.b[i]
            for i in range(self.n_out)
        )
        return AffineMap(A, b)

    def inverse(self) -> "AffineMap":
        """Exact rational inverse (square, nonsingular); raises ValueError."""
        n = self.n_out
        if n != self.n_in:
            raise ValueError(f"non-square map {self.n_out}x{self.n_in}")
        # Gauss-Jordan over Fractions on [A | I].
        aug = [list(row) + [Frac(1) if i == j else Frac(0) for j in range(n)]
               for i, row in enumerate(self.A)]
        for col in range(n):
            piv = next((r for r in range(col, n) if aug[r][col] != 0), None)
            if piv is None:
                raise ValueError("singular affine map (fan-out op, e.g. Upsample)")
            aug[col], aug[piv] = aug[piv], aug[col]
            pv = aug[col][col]
            aug[col] = [v / pv for v in aug[col]]
            for r in range(n):
                if r != col and aug[r][col] != 0:
                    f = aug[r][col]
                    aug[r] = [v - f * w for v, w in zip(aug[r], aug[col])]
        Ainv = tuple(tuple(aug[i][n:]) for i in range(n))
        inv = AffineMap(Ainv, tuple(Frac(0) for _ in range(n)))
        # b' = -Ainv @ b
        binv = tuple(
            -sum((Ainv[i][k] * self.b[k] for k in range(n)), Frac(0)) for i in range(n)
        )
        return AffineMap(Ainv, binv)

    # --- predicates -------------------------------------------------------
    def is_integral(self) -> bool:
        return all(a.denominator == 1 for row in self.A for a in row) and all(
            v.denominator == 1 for v in self.b
        )

    def is_permutation(self) -> bool:
        if self.n_out != self.n_in or any(v != 0 for v in self.b):
            return False
        seen = set()
        for row in self.A:
            ones = [j for j, a in enumerate(row) if a == 1]
            zeros_ok = all(a in (0, 1) for a in row)
            if not zeros_ok or len(ones) != 1 or ones[0] in seen:
                return False
            seen.add(ones[0])
        return True

    def __repr__(self) -> str:  # compact
        rows = ["[" + " ".join(str(a) for a in row) + "]" for row in self.A]
        return f"AffineMap(A={rows}, b=[{' '.join(str(v) for v in self.b)}])"


# ---------------------------------------------------------------------------
# Paper Table II — the exact (A, B) register values, for fidelity + tests.
# These use the paper's linearized-row-stride convention (w_i baked into A).
# ---------------------------------------------------------------------------

def paper_table2(op: str, *, w_i: int = 0, s: int = 1,
                 x_s: int = 1, y_s: int = 1, x_p: int = 0, y_p: int = 0,
                 x_k: int = 1, y_k: int = 1) -> AffineMap:
    """The verbatim (A, B) pairs of paper Table II.

    Input vector is ``(x_i, y_i, c_i)`` (``(x_i, y_i, c_i1, c_i2)`` for
    Route); output is ``(x_o, y_o, c_o)``.  Kept for documentation and
    fidelity tests; the executable engine uses :func:`gather_map`.
    """
    F = Frac
    if op == "transpose":
        return AffineMap.make([[0, 1, 0], [w_i, 0, 0], [0, 0, 1]])
    if op == "rot90":
        return AffineMap.make([[0, -1, 0], [w_i, 0, 0], [0, 0, 1]], [w_i, 0, 0])
    if op == "img2col":
        return AffineMap.make(
            [[F(1, x_s), 0, 0], [0, F(w_i, y_s), 0], [0, 0, 1]],
            [F(2 * x_p - x_k, x_s) + 1, F(2 * y_p - y_k, y_s) + 1, 0],
        )
    if op == "pixelshuffle":
        return AffineMap.make([[1, 0, 0], [0, s * w_i, 0], [0, 0, F(1, s)]])
    if op == "pixelunshuffle":
        return AffineMap.make([[s, 0, 0], [0, w_i, 0], [0, 0, 1]])
    if op == "upsample":
        return AffineMap.make([[s, 0, 0], [0, s * s * w_i, 0], [0, 0, 1]])
    if op == "route":
        return AffineMap.make([[1, 0, 0, 0], [0, w_i, 0, 0], [0, 0, 1, 1]])
    if op == "split":
        return AffineMap.make([[1, 0, 0], [0, w_i, 0], [0, 0, F(1, s)]])
    if op == "add":
        return AffineMap.make([[1, 0, 0], [0, w_i, 0], [0, 0, 1]])
    raise KeyError(f"unknown Table II operator: {op}")


# ---------------------------------------------------------------------------
# MixedRadixMap — executable gather form of the unified address abstraction.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DigitSplit:
    """Replace output coordinate ``axis`` with ``(coord // radix, coord % radix)``.

    Splits are applied left-to-right; each split grows the digit vector by one
    (quotient takes the original position, remainder is appended at the end in
    split order).
    """

    axis: int
    radix: int


@dataclasses.dataclass(frozen=True)
class MixedRadixMap:
    """Gather-form unified address map: output coords -> input coords.

    Pipeline (all exact integer arithmetic):

      1. digits = expand(out_coords) via ``splits`` (mixed-radix expansion)
      2. in_coords = floor(A @ digits + b)  — ``A``/``b`` exact rationals
      3. OOB handling: coordinates outside ``in_shape`` read ``fill`` (this is
         how Img2col padding and Rot/offset edges are expressed)

    ``in_shape``/``out_shape`` are the full tensor shapes; ``n_digits`` =
    ``len(out_shape) + len(splits)``.

    This structure is exactly what a TMU instruction encodes: the splits are
    the radix registers, (A, b) the transformation-matrix registers, fill the
    padding register.  It is also serializable (see :meth:`encode`).
    """

    out_shape: tuple[int, ...]
    in_shape: tuple[int, ...]
    splits: tuple[DigitSplit, ...]
    affine: AffineMap  # digits -> input coords
    fill: float = 0.0
    oob_possible: bool = False  # any digit vector can map outside in_shape
    # extra validity constraints ``digit[i] < bound`` (hardware: digit-range
    # mask registers).  Needed when a quotient digit over-covers (e.g.
    # Rearrange channel padding: group digit must stay < group).
    digit_bounds: tuple[tuple[int, int], ...] = ()

    def __hash__(self):
        return memoized_hash(self, self.out_shape, self.in_shape,
                             self.splits, self.affine, self.fill,
                             self.oob_possible, self.digit_bounds)

    def __post_init__(self):
        n_digits = len(self.out_shape) + len(self.splits)
        assert self.affine.n_in == n_digits, (self.affine.n_in, n_digits)
        assert self.affine.n_out == len(self.in_shape)

    # --- exact (python int) evaluation, the oracle used by tests ----------
    def expand_digits(self, out_coord: Sequence[int]) -> tuple[int, ...]:
        digits = list(out_coord)
        extra: list[int] = []
        for sp in self.splits:
            q, r = divmod(digits[sp.axis], sp.radix)
            digits[sp.axis] = q
            extra.append(r)
        return tuple(digits) + tuple(extra)

    def gather_coord(self, out_coord: Sequence[int]) -> tuple[tuple[int, ...], bool]:
        """Return (input coordinate, in_bounds)."""
        digits = self.expand_digits(out_coord)
        ic = self.affine.apply(digits)
        ok = all(0 <= c < s for c, s in zip(ic, self.in_shape))
        for d, bound in self.digit_bounds:
            ok = ok and digits[d] < bound
        return ic, ok

    # --- serialization: the "TM instruction fields" ------------------------
    def encode(self) -> dict:
        return {
            "out_shape": list(self.out_shape),
            "in_shape": list(self.in_shape),
            "splits": [[sp.axis, sp.radix] for sp in self.splits],
            "A": [[[a.numerator, a.denominator] for a in row] for row in self.affine.A],
            "b": [[v.numerator, v.denominator] for v in self.affine.b],
            "fill": self.fill,
            "oob_possible": self.oob_possible,
            "digit_bounds": [list(db) for db in self.digit_bounds],
        }

    @staticmethod
    def decode(d: dict) -> "MixedRadixMap":
        A = tuple(tuple(Frac(n, m) for n, m in row) for row in d["A"])
        b = tuple(Frac(n, m) for n, m in d["b"])
        return MixedRadixMap(
            out_shape=tuple(d["out_shape"]),
            in_shape=tuple(d["in_shape"]),
            splits=tuple(DigitSplit(a, r) for a, r in d["splits"]),
            affine=AffineMap(A, b),
            fill=d["fill"],
            oob_possible=d["oob_possible"],
            digit_bounds=tuple(tuple(db) for db in d.get("digit_bounds", [])),
        )

    # --- predicates used by the fusion / kernel planners -------------------
    def is_pure_permutation(self) -> bool:
        """True if no splits and the affine part is a coordinate permutation."""
        return not self.splits and self.affine.is_permutation()

    def permutation(self) -> tuple[int, ...]:
        assert self.is_pure_permutation()
        perm = []
        for row in self.affine.A:
            perm.append(next(j for j, a in enumerate(row) if a == 1))
        return tuple(perm)


# ---------------------------------------------------------------------------
# Operator library — gather maps for every Table II op (+ fine-grained ones
# that admit an affine gather form).  Conventions: tensors are channel-last
# (H, W, C) unless stated; batch handled by the engine (leading axes pass
# through, see tm_ops).
# ---------------------------------------------------------------------------

def _rows(n_in: int, entries: dict[int, dict[int, Frac]], offs: dict[int, Frac],
          n_out: int) -> AffineMap:
    A = [[Frac(0)] * n_in for _ in range(n_out)]
    b = [Frac(0)] * n_out
    for i, row in entries.items():
        for j, v in row.items():
            A[i][j] = Frac(v)
    for i, v in offs.items():
        b[i] = Frac(v)
    return AffineMap(tuple(tuple(r) for r in A), tuple(b))


def transpose_map(in_shape: tuple[int, int, int]) -> MixedRadixMap:
    """(H, W, C) -> (W, H, C): swap spatial dims (paper Transpose)."""
    H, W, C = in_shape
    return MixedRadixMap(
        out_shape=(W, H, C), in_shape=in_shape, splits=(),
        affine=AffineMap.permutation([1, 0, 2]),
    )


def rot90_map(in_shape: tuple[int, int, int]) -> MixedRadixMap:
    """(H, W, C) -> (W, H, C), 90° CCW: out[y, x, c] = in[x, W-1-y, c]."""
    H, W, C = in_shape
    aff = _rows(
        3,
        {0: {1: Frac(1)}, 1: {0: Frac(-1)}, 2: {2: Frac(1)}},
        {1: Frac(W - 1)},
        3,
    )
    return MixedRadixMap(out_shape=(W, H, C), in_shape=in_shape, splits=(), affine=aff)


def pixel_shuffle_map(in_shape: tuple[int, int, int], s: int) -> MixedRadixMap:
    """(H, W, C*s²) -> (H*s, W*s, C).  out[y, x, c] = in[y//s, x//s, c*s² + (y%s)*s + (x%s)]."""
    H, W, Cs2 = in_shape
    assert Cs2 % (s * s) == 0, (in_shape, s)
    C = Cs2 // (s * s)
    # digits after splits (axis0 by s, axis1 by s): (yq, xq, c, yr, xr)
    aff = _rows(
        5,
        {
            0: {0: Frac(1)},                       # y_i = yq
            1: {1: Frac(1)},                       # x_i = xq
            2: {2: Frac(s * s), 3: Frac(s), 4: Frac(1)},  # c_i = c*s² + yr*s + xr
        },
        {},
        3,
    )
    return MixedRadixMap(
        out_shape=(H * s, W * s, C), in_shape=in_shape,
        splits=(DigitSplit(0, s), DigitSplit(1, s)), affine=aff,
    )


def pixel_unshuffle_map(in_shape: tuple[int, int, int], s: int) -> MixedRadixMap:
    """(H*s, W*s, C) -> (H, W, C*s²).  out[y, x, c] with c = c_in*s² + dy*s + dx."""
    Hs, Ws, C = in_shape
    assert Hs % s == 0 and Ws % s == 0, (in_shape, s)
    H, W = Hs // s, Ws // s
    # split output channel axis by s twice: c -> (cq, rem) radix s*s? Two-stage:
    # first split axis2 by s: (y, x, cq, dx) with dx = c % s
    # then split axis2 (now cq = c // s) by s: (y, x, cqq, dx, dy) dy = (c//s) % s
    # c_in = cqq ; y_i = y*s + dy ; x_i = x*s + dx
    aff = _rows(
        5,
        {
            0: {0: Frac(s), 4: Frac(1)},   # y_i = y*s + dy
            1: {1: Frac(s), 3: Frac(1)},   # x_i = x*s + dx
            2: {2: Frac(1)},               # c_i = cqq
        },
        {},
        3,
    )
    return MixedRadixMap(
        out_shape=(H, W, C * s * s), in_shape=in_shape,
        splits=(DigitSplit(2, s), DigitSplit(2, s)), affine=aff,
    )


def upsample_map(in_shape: tuple[int, int, int], s: int) -> MixedRadixMap:
    """Nearest-neighbour upsample: (H, W, C) -> (H*s, W*s, C) (paper Upsample)."""
    H, W, C = in_shape
    # splits: (yq, xq, c, yr, xr); drop remainders (zero columns) => fan-out.
    aff = _rows(
        5,
        {0: {0: Frac(1)}, 1: {1: Frac(1)}, 2: {2: Frac(1)}},
        {},
        3,
    )
    return MixedRadixMap(
        out_shape=(H * s, W * s, C), in_shape=in_shape,
        splits=(DigitSplit(0, s), DigitSplit(1, s)), affine=aff,
    )


def split_map(in_shape: tuple[int, int, int], n: int, part: int) -> MixedRadixMap:
    """Channel Split: part ``part`` of ``n`` equal channel slices."""
    H, W, C = in_shape
    assert C % n == 0
    Cp = C // n
    aff = _rows(
        3,
        {0: {0: Frac(1)}, 1: {1: Frac(1)}, 2: {2: Frac(1)}},
        {2: Frac(part * Cp)},
        3,
    )
    return MixedRadixMap(out_shape=(H, W, Cp), in_shape=in_shape, splits=(), affine=aff)


def route_maps(shapes: Sequence[tuple[int, int, int]]) -> list[MixedRadixMap]:
    """Route/Concat along channels: one gather map per input, each writing its
    channel band of the output (the scatter-side view of paper Route)."""
    H, W = shapes[0][0], shapes[0][1]
    Ctot = sum(s[2] for s in shapes)
    maps = []
    off = 0
    for shp in shapes:
        assert shp[0] == H and shp[1] == W
        aff = _rows(
            3,
            {0: {0: Frac(1)}, 1: {1: Frac(1)}, 2: {2: Frac(1)}},
            {2: Frac(-off)},
            3,
        )
        maps.append(
            MixedRadixMap(
                out_shape=(H, W, Ctot), in_shape=shp, splits=(), affine=aff,
                oob_possible=True,  # out-of-band channels belong to other inputs
            )
        )
        off += shp[2]
    return maps


def img2col_map(in_shape: tuple[int, int, int], kh: int, kw: int,
                stride: int = 1, pad: int = 0, fill: float = 0.0) -> MixedRadixMap:
    """Img2col: (H, W, C) -> (OH*OW, KH*KW*C) patch matrix (paper Img2col).

    out[p, k]: p = oy*OW + ox ; k = (ky*KW + kx)*C + c
    in coords:  y = oy*stride + ky - pad ; x = ox*stride + kx - pad
    Exactly affine over digits (oy, ox, ky, kx, c); padding = OOB fill.
    """
    H, W, C = in_shape
    OH = (H + 2 * pad - kh) // stride + 1
    OW = (W + 2 * pad - kw) // stride + 1
    # out_shape = (OH*OW, KH*KW*C)
    # splits: axis0 by OW -> (oy, ox...); axis1 by C -> (kflat, c); axis1 by KW -> (ky, c, kx)
    # Order: split(0, OW): digits (oy, kflatC, ox)
    #        split(1, C): (oy, kflat, ox, c)
    #        split(1, KW): (oy, ky, ox, c, kx)
    aff = _rows(
        5,
        {
            0: {0: Frac(stride), 1: Frac(1)},  # y = oy*stride + ky - pad
            1: {2: Frac(stride), 4: Frac(1)},  # x = ox*stride + kx - pad
            2: {3: Frac(1)},                   # c
        },
        {0: Frac(-pad), 1: Frac(-pad)},
        3,
    )
    return MixedRadixMap(
        out_shape=(OH * OW, kh * kw * C), in_shape=in_shape,
        splits=(DigitSplit(0, OW), DigitSplit(1, C), DigitSplit(1, kw)),
        affine=aff, fill=fill, oob_possible=pad > 0,
    )


def rearrange_map(in_shape: tuple[int, int, int], group: int,
                  pad_c: int) -> MixedRadixMap:
    """Paper Rearrange: RGB stream -> higher-channel fmap favouring bursts.

    (H, W*group, C) -> (H, W, C*group) then zero-pad channels to ``pad_c``
    (e.g. 448x448x3 -> 448x448x16 with group=4 padding 12->16).  Gather form:
    out[y, x, c]: g = c // C ; c_in = c % C ; x_in = x*group + g.
    """
    H, Wg, C = in_shape
    assert Wg % group == 0
    W = Wg // group
    Cout = C * group
    assert pad_c >= Cout
    # split axis2 by C: digits (y, x, g, c_r)  [g = c // C, c_r = c % C]
    aff = _rows(
        4,
        {
            0: {0: Frac(1)},
            1: {1: Frac(group), 2: Frac(1)},  # x_in = x*group + g
            2: {3: Frac(1)},
        },
        {},
        3,
    )
    return MixedRadixMap(
        out_shape=(H, W, pad_c), in_shape=in_shape,
        splits=(DigitSplit(2, C),), affine=aff, fill=0.0,
        oob_possible=pad_c > Cout,
        # after splitting c by C, digit 2 is g = c // C; pad region has
        # g >= group and must read fill, not aliased pixels.
        digit_bounds=((2, group),) if pad_c > Cout else (),
    )


def strided_slice_map(in_shape: tuple[int, ...], starts: Sequence[int],
                      strides: Sequence[int],
                      out_shape: tuple[int, ...]) -> MixedRadixMap:
    """Strided slice as a pure (A, B) pair: in = diag(strides)·out + starts.

    Another op the original TMU never shipped — added here with zero new
    datapath code (the reconfigurability claim, exercised)."""
    n = len(in_shape)
    A = [[Frac(strides[i]) if i == j else Frac(0) for j in range(n)]
         for i in range(n)]
    return MixedRadixMap(
        out_shape=tuple(out_shape), in_shape=tuple(in_shape), splits=(),
        affine=AffineMap(tuple(tuple(r) for r in A),
                         tuple(Frac(s) for s in starts)),
    )


def axis_permutation_map(in_shape: tuple[int, ...],
                         perm: Sequence[int]) -> MixedRadixMap:
    """lax.transpose as a coarse map: out axis ``i`` carries in axis ``perm[i]``."""
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return MixedRadixMap(
        out_shape=tuple(in_shape[p] for p in perm), in_shape=tuple(in_shape),
        splits=(), affine=AffineMap.permutation(inv),
    )


def flip_map(in_shape: tuple[int, ...], axes: Sequence[int]) -> MixedRadixMap:
    """lax.rev: in[d] = (size_d - 1) - out[d] on flipped axes (Rot90's core)."""
    n = len(in_shape)
    axes = set(axes)
    A = [[Frac(1 if i == j and i not in axes else
               -1 if i == j else 0) for j in range(n)] for i in range(n)]
    b = [Frac(in_shape[i] - 1) if i in axes else Frac(0) for i in range(n)]
    return MixedRadixMap(
        out_shape=tuple(in_shape), in_shape=tuple(in_shape), splits=(),
        affine=AffineMap(tuple(tuple(r) for r in A), tuple(b)),
    )


def pad_map(in_shape: tuple[int, ...], lo: Sequence[int], hi: Sequence[int],
            fill: float = 0.0) -> MixedRadixMap:
    """lax.pad (no interior dilation): in = out - lo, OOB reads ``fill``.

    Negative lo/hi (cropping) stay exact — they only shift the window."""
    n = len(in_shape)
    out_shape = tuple(s + l + h for s, l, h in zip(in_shape, lo, hi))
    A = [[Frac(1 if i == j else 0) for j in range(n)] for i in range(n)]
    b = [Frac(-l) for l in lo]
    return MixedRadixMap(
        out_shape=out_shape, in_shape=tuple(in_shape), splits=(),
        affine=AffineMap(tuple(tuple(r) for r in A), tuple(b)), fill=fill,
        oob_possible=any(l > 0 or h > 0 for l, h in zip(lo, hi)),
    )


def concat_maps(shapes: Sequence[tuple[int, ...]],
                axis: int) -> list[MixedRadixMap]:
    """lax.concatenate along any axis: one band map per input (generalizes
    :func:`route_maps`, which is the channel-axis special case)."""
    n = len(shapes[0])
    total = sum(s[axis] for s in shapes)
    out_shape = tuple(total if d == axis else shapes[0][d] for d in range(n))
    maps, off = [], 0
    for shp in shapes:
        A = [[Frac(1 if i == j else 0) for j in range(n)] for i in range(n)]
        b = [Frac(-off) if i == axis else Frac(0) for i in range(n)]
        maps.append(MixedRadixMap(
            out_shape=out_shape, in_shape=tuple(shp), splits=(),
            affine=AffineMap(tuple(tuple(r) for r in A), tuple(b)),
            oob_possible=True,  # out-of-band coords belong to other inputs
        ))
        off += shp[axis]
    return maps


def update_slice_maps(in_shape: tuple[int, ...], upd_shape: tuple[int, ...],
                      starts: Sequence[int],
                      ) -> tuple[MixedRadixMap, MixedRadixMap]:
    """lax.dynamic_update_slice (constant, pre-clamped starts) as an
    *overlay* Route pair: ``(base, window)``.

    The base band is the identity over the operand; the window band places
    the update at ``starts`` (a pure pad-map shift) and is out-of-bounds
    everywhere else.  The two supports overlap on the update window, so the
    pair only makes sense under overlay (last-writer-wins) Route semantics —
    ``route_gather(..., overlay=True)`` — where the window band overwrites
    the base exactly where it is valid.  This is the KV-cache append: one
    scatter-style TM instruction whose register contents encode the decode
    position."""
    lo = [int(s) for s in starts]
    hi = [int(d - s - u)
          for d, s, u in zip(in_shape, lo, upd_shape)]
    if any(h < 0 for h in hi) or any(s < 0 for s in lo):
        raise ValueError(
            f"update window {upd_shape} @ {starts} exceeds {in_shape}")
    return identity_map(tuple(in_shape)), pad_map(tuple(upd_shape), lo, hi)


def index_select_map(in_shape: tuple[int, ...], axis: int, start: int,
                     step: int, n: int) -> MixedRadixMap:
    """Row gather at the arithmetic progression ``start + j*step`` along
    ``axis`` (``jnp.take`` with regularly spaced indices): a strided-slice
    map whose stride may be 0 (repeat one row) or negative (reverse)."""
    nd = len(in_shape)
    starts = tuple(start if d == axis else 0 for d in range(nd))
    strides = tuple(step if d == axis else 1 for d in range(nd))
    out_shape = tuple(n if d == axis else in_shape[d] for d in range(nd))
    return strided_slice_map(tuple(in_shape), starts, strides, out_shape)


def index_select_band_maps(in_shape: tuple[int, ...], axis: int,
                           indices: Sequence[int]) -> list[MixedRadixMap]:
    """Arbitrary constant row gather along ``axis`` (``jnp.take``) as one
    band map per index, sharing the operand as every band's source.

    Band ``j`` reads ``in[.., idx_j, ..]`` into ``out[.., j, ..]``; at any
    other output position its input coordinate is pushed past the axis size
    (``in = M·(out - j) + idx_j`` with ``M >= dim``), so band supports are
    disjoint and the plain band-sum Route reconstructs the gather exactly."""
    nd = len(in_shape)
    M = max(int(in_shape[axis]), 1)
    n = len(indices)
    out_shape = tuple(n if d == axis else in_shape[d] for d in range(nd))
    maps = []
    for j, idx in enumerate(indices):
        A = [[Frac(1 if (i == d and i != axis) else 0) for d in range(nd)]
             for i in range(nd)]
        A[axis][axis] = Frac(M)
        b = [Frac(0)] * nd
        b[axis] = Frac(int(idx) - M * j)
        maps.append(MixedRadixMap(
            out_shape=out_shape, in_shape=tuple(in_shape), splits=(),
            affine=AffineMap(tuple(tuple(r) for r in A), tuple(b)),
            oob_possible=True,
        ))
    return maps


def broadcast_map(in_shape: tuple[int, ...], out_shape: tuple[int, ...],
                  bcast_dims: Sequence[int]) -> MixedRadixMap:
    """lax.broadcast_in_dim as a fan-out gather: in[i] = out[bcast_dims[i]],
    or the constant 0 where a size-1 input axis is stretched."""
    n_in, n_out = len(in_shape), len(out_shape)
    A = [[Frac(0)] * n_out for _ in range(n_in)]
    for i, d in enumerate(bcast_dims):
        if in_shape[i] == out_shape[d]:
            A[i][d] = Frac(1)
        # stretched (in size 1): row stays zero -> in coord 0 for every out
    return MixedRadixMap(
        out_shape=tuple(out_shape), in_shape=tuple(in_shape), splits=(),
        affine=AffineMap(tuple(tuple(r) for r in A),
                         tuple(Frac(0) for _ in range(n_in))),
    )


def reshape_map(in_shape: tuple[int, ...],
                out_shape: tuple[int, ...]) -> MixedRadixMap | None:
    """Row-major reshape as a mixed-radix map, when exactly representable.

    Both shapes are refined to their *common factorization* (the merge of the
    two suffix-product boundary sets).  Each output dim then splits into its
    refined digits (radix registers) and each input coordinate is an integer
    combination of digits (the (A, B) registers) — e.g. the reshape halves of
    PixelShuffle/PixelUnshuffle fall out of this construction.  Returns None
    when the boundary sets don't nest (a genuinely interleaving reshape, e.g.
    (6, 4) -> (8, 3)), which a TMU would also split into two instructions.
    """
    import math
    total = math.prod(in_shape)
    if total != math.prod(out_shape) or total == 0 or not in_shape or not out_shape:
        return None

    def suffixes(shape):
        out, acc = [], 1
        for s in reversed(shape):
            out.append(acc)
            acc *= s
        return list(reversed(out))  # suffixes[i] = prod(shape[i+1:])

    in_suf, out_suf = suffixes(in_shape), suffixes(out_shape)
    bounds = sorted(set(in_suf) | set(out_suf) | {1, total}, reverse=True)
    radii = []
    for a, b in zip(bounds, bounds[1:]):
        if a % b:
            return None  # boundaries don't nest: not mixed-radix representable
        radii.append(a // b)
    # refined factor k spans flat sizes (bounds[k], bounds[k+1]]
    def run_of(left, right):  # dim spans [left, right) boundary values
        return [k for k in range(len(radii))
                if bounds[k] <= left and bounds[k + 1] >= right]

    splits: list[DigitSplit] = []
    digit_of: dict[int, int] = {}  # refined factor -> digit index
    n_out = len(out_shape)
    for j, (size, suf) in enumerate(zip(out_shape, out_suf)):
        run = run_of(size * suf, suf)
        if not run:
            continue  # size-1 dim: its digit is unused
        digit_of[run[0]] = j  # most-significant factor = final quotient
        for k in reversed(run[1:]):  # least-significant remainder first
            digit_of[k] = n_out + len(splits)
            splits.append(DigitSplit(j, radii[k]))
    n_dig = n_out + len(splits)
    A = [[Frac(0)] * n_dig for _ in range(len(in_shape))]
    for i, (size, suf) in enumerate(zip(in_shape, in_suf)):
        stride = 1
        for k in reversed(run_of(size * suf, suf)):
            A[i][digit_of[k]] = Frac(stride)
            stride *= radii[k]
    return MixedRadixMap(
        out_shape=tuple(out_shape), in_shape=tuple(in_shape),
        splits=tuple(splits),
        affine=AffineMap(tuple(tuple(r) for r in A),
                         tuple(Frac(0) for _ in range(len(in_shape)))),
    )


def identity_map(shape: tuple[int, ...]) -> MixedRadixMap:
    n = len(shape)
    return MixedRadixMap(
        out_shape=shape, in_shape=shape, splits=(),
        affine=AffineMap.identity(n),
    )


def batch_extend_map(m: MixedRadixMap,
                     batch_shape: tuple[int, ...]) -> MixedRadixMap:
    """Lift a core map over leading batch axes: identity ⊗ m.

    The batched map's digit vector is ``(batch coords, core digits)`` — every
    core digit index shifts by ``len(batch_shape)`` (splits move to shifted
    axes; remainders still append after all output coords, which is exactly
    ``+B`` positions later).  This lets the Pallas backend execute batched
    programs through the unmodified kernels: the batch axes become extra grid
    dimensions / gather rows, no vmap required.
    """
    B = len(batch_shape)
    if B == 0:
        return m
    n_out = len(m.out_shape)
    n_dig = n_out + len(m.splits)
    A = [[Frac(0)] * (B + n_dig) for _ in range(B + len(m.in_shape))]
    b = [Frac(0)] * (B + len(m.in_shape))
    for i in range(B):  # batch coords pass through
        A[i][i] = Frac(1)
    for i, (row, off) in enumerate(zip(m.affine.A, m.affine.b)):
        for j, v in enumerate(row):
            A[B + i][B + j] = v
        b[B + i] = off
    return MixedRadixMap(
        out_shape=batch_shape + m.out_shape,
        in_shape=batch_shape + m.in_shape,
        splits=tuple(DigitSplit(sp.axis + B, sp.radix) for sp in m.splits),
        affine=AffineMap(tuple(tuple(r) for r in A), tuple(b)),
        fill=m.fill,
        oob_possible=m.oob_possible,
        digit_bounds=tuple((d + B, bound) for d, bound in m.digit_bounds),
    )


def compose_maps(outer: MixedRadixMap, inner: MixedRadixMap) -> MixedRadixMap | None:
    """Fuse two gather maps into one (outer applied after inner, i.e. the data
    flows inner -> outer; the composed gather is inner_map ∘ outer_map on
    coordinates).  Returns None when not exactly fusable (splits on the outer
    map's intermediate coords that do not commute, or rational intermediates).

    Handled case — covers every chain the fusion pass builds: the *outer* map
    has no splits and an integral affine part (pure permutation / offset ops:
    Transpose, Rot90, Split, Route bands, Add).  Then
        in = inner.affine(expand_inner(mid))  with  mid = outer.affine(out)
    and expand_inner(outer.affine(out)) is affine over expand(out) only if
    inner has no splits either, OR outer is a pure permutation (splits can be
    re-indexed through a permutation).
    """
    # data flow: x --inner--> y --outer--> z. Gather: z-coord -> y-coord via
    # outer, y-coord -> x-coord via inner. Compose inner ∘ outer.
    assert inner.out_shape == outer.in_shape, (inner.out_shape, outer.in_shape)
    if outer.oob_possible or outer.digit_bounds or inner.digit_bounds:
        # fusing would lose the intermediate bounds/fill information — fall
        # back to two passes (a TMU would likewise issue two instructions).
        return None
    if outer.splits == () and outer.affine.is_integral():
        if inner.splits == ():
            aff = inner.affine.compose(outer.affine)
            return MixedRadixMap(
                out_shape=outer.out_shape, in_shape=inner.in_shape, splits=(),
                affine=aff, fill=inner.fill,
                oob_possible=inner.oob_possible or outer.oob_possible,
            )
        if outer.affine.is_permutation():
            # mid[i] = out[perm[i]], so splitting mid-axis a == splitting
            # out-axis perm[a] (same radices, same order -> remainders align).
            perm = [next(j for j, a in enumerate(row) if a == 1)
                    for row in outer.affine.A]
            new_splits = tuple(DigitSplit(perm[sp.axis], sp.radix) for sp in inner.splits)
            # digit vector of out = perm applied to first block; remainders align.
            n_mid = len(inner.out_shape)
            n_dig = n_mid + len(inner.splits)
            # build permutation matrix on digit space: digit i of mid = digit ?
            P = [[Frac(0)] * n_dig for _ in range(n_dig)]
            for i in range(n_mid):
                P[i][perm[i]] = Frac(1)
            for k in range(len(inner.splits)):
                P[n_mid + k][n_mid + k] = Frac(1)
            aff = inner.affine.compose(AffineMap(tuple(tuple(r) for r in P),
                                                 tuple(Frac(0) for _ in range(n_dig))))
            return MixedRadixMap(
                out_shape=outer.out_shape, in_shape=inner.in_shape,
                splits=new_splits, affine=aff, fill=inner.fill,
                oob_possible=inner.oob_possible or outer.oob_possible,
            )
    if inner.splits == () and inner.affine.is_integral() and outer.affine.is_integral():
        # inner is a pure integral affine map: compose under outer's splits.
        # outer.oob_possible is guarded False above, so the only live fill
        # register is the inner one (e.g. pad's constant).
        aff = inner.affine.compose(outer.affine)
        return MixedRadixMap(
            out_shape=outer.out_shape, in_shape=inner.in_shape,
            splits=outer.splits, affine=aff, fill=inner.fill,
            oob_possible=inner.oob_possible or outer.oob_possible,
        )
    return None
