"""State-space / linear-attention blocks: Mamba2 (SSD) and RWKV6 (Finch).

The JAX package's ``models/ssm.py`` with PyTorch tensors.  TM-layer
reading, as there:
  * RWKV6 token shift — the paper's **Rearrange** along time;
  * per-head state layout transposes — coarse TM;
  * chunked recurrences — the Branch stage of the execution model: long
    tensors processed in segments with carried state (here a Python loop
    over the chunks, where the JAX package scans).

Both blocks have a single-token form (O(1) state decode) and a chunked
form for prefill.  JAX promotes a bf16 weight to f32 inside a product with
an f32 operand; ``torch.matmul`` refuses mixed dtypes, so such a weight is
cast here to the promoted type of the two explicitly.  (A training step
casts every leaf to the model's dtype, RWKV6's f32 mixers among them, so
after it the mixes and the weights are both bf16.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _norm_init
from repro_torch.runtime.sharding import (BANDS_PRODUCT, BANDS_WEIGHT,
                                          BANDS_WHOLE, band_layout, local,
                                          local_block, ranks_of, shard,
                                          whole_seq, with_partial)


# ===========================================================================
# Mamba2-style SSD block (scalar-per-head decay, chunked linear recurrence)
# ===========================================================================

def init_mamba2(gen, d_model: int, d_state: int = 64, expand: int = 2,
                head_dim: int = 64, dtype=torch.float32):
    """Returns ``(params, meta)`` (the JAX package also returns specs)."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    d_proj = 2 * d_inner + 2 * d_state + n_heads  # fused (z, x, B, C, dt)
    dev = gen.device
    dt = torch.linspace(1e-3, 0.1, n_heads, dtype=torch.float32, device=dev)
    params = {
        "win": _norm_init(gen, (d_model, d_proj), d_model ** -0.5).to(dtype),
        "wout": _norm_init(gen, (d_inner, d_model),
                           d_inner ** -0.5).to(dtype),
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.exp(dt) - 1.0 + 1e-9)}
    meta = dict(d_inner=d_inner, n_heads=n_heads, head_dim=head_dim,
                d_state=d_state)
    return params, meta


# logical sharding axes of init_mamba2's leaves (runtime.sharding)
MAMBA2_SPECS = {"win": ("embed_fsdp", "mlp"), "wout": ("mlp", "embed_fsdp"),
                "A_log": (None,), "D": (None,), "dt_bias": (None,)}


def _mamba2_split(p, u, meta):
    """One product, TM Split into (z, x, B, C, dt) column bands (views).
    The product, its columns over "mlp" under the rules, is gathered
    once before the split: a band's slice of the sharded dim would gather
    the whole product for each band.  Unlike attention's and RWKV6's
    bands (:func:`band_layout`), the weight never goes first: the bands'
    consumers (the depthwise conv over x, B and C together, the SSD scan,
    the gated norm over z) run whole on every rank, so a product of the
    gathered weight would have every rank compute the whole product, its
    FLOPs times the "mlp" ranks, where the gather saves no more than the
    product's bytes."""
    d_inner, d_state = meta["d_inner"], meta["d_state"]
    proj = shard(whole_seq(u) @ p["win"], ("batch", None, "mlp"))
    proj = shard(proj, ("batch", None, None))
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    Bm = proj[..., 2 * d_inner:2 * d_inner + d_state]
    Cm = proj[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, x, Bm, Cm, dt


def _decay(p, dt):
    """Softplus step and per-head decay a = exp(-dt · exp(A_log)), f32."""
    dt = F.softplus(dt.float() + p["dt_bias"])
    return torch.exp(-dt * torch.exp(p["A_log"]))


def _ssd_chunk(h, ac, xc, Bc, Cc):
    """One chunk of the SSD recurrence.  h (B, H, P, N); ac (c, B, H), xc
    (c, B, H, P), Bc, Cc (c, B, N).  Returns ``(h', y (c, B, H, P))``."""
    c = ac.shape[0]
    la = torch.log(torch.clamp(ac, min=1e-30))          # log-space decay
    cum = torch.cumsum(la, dim=0)                       # prod_{u<=t} a_u
    dec_t = torch.exp(cum)
    hC = torch.einsum("bhpn,cbn->cbhp", h, Cc)
    y_state = hC * dec_t[..., None]
    # decay(s -> t) = exp(cum[t] - cum[s]) for s <= t
    dmat = torch.exp(cum[None, :, :, :] - cum[:, None, :, :])  # (s, t, B, H)
    ar = torch.arange(c, device=ac.device)
    smask = ar[:, None] <= ar[None, :]
    dmat = torch.where(smask[:, :, None, None], dmat, 0.0)
    bc = torch.einsum("sbn,tbn->stb", Bc, Cc)
    w = dmat * bc[:, :, :, None]
    y_intra = torch.einsum("stbh,sbhp->tbhp", w, xc)
    dec_all = torch.exp(cum[-1])                        # (B, H)
    dec_tail = torch.exp(cum[-1][None] - cum)           # (c, B, H)
    outer = torch.einsum("cbh,cbhp,cbn->bhpn", dec_tail, xc, Bc)
    h_new = h * dec_all[..., None, None] + outer
    return h_new, y_state + y_intra


def mamba2_block(p, u, meta, *, chunk: int = 256, h0=None,
                 return_state: bool = False):
    """u: (B, S, D) -> (B, S, D).  Chunked SSD recurrence; ``h0`` (B, H, P,
    N) f32 seeds it, ``return_state`` also returns the final state."""
    B, S, _ = u.shape
    H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
    z, x, Bm, Cm, dt = _mamba2_split(p, u, meta)
    a = _decay(p, dt)                                   # (B, S, H)
    xh = x.reshape(B, S, H, P).float()
    Bf, Cf = Bm.float(), Cm.float()

    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    nc = S // chunk
    ac = a.transpose(0, 1).reshape(nc, chunk, B, H)
    xc = xh.transpose(0, 1).reshape(nc, chunk, B, H, P)
    Bc = Bf.transpose(0, 1).reshape(nc, chunk, B, N)
    Cc = Cf.transpose(0, 1).reshape(nc, chunk, B, N)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=u.device) \
        if h0 is None else h0
    ys = []
    for i in range(nc):
        h, y = _ssd_chunk(h, ac[i], xc[i], Bc[i], Cc[i])
        ys.append(y)
    y = torch.stack(ys).reshape(nc * chunk, B, H, P).transpose(0, 1)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, -1) * F.silu(z.float())
    out = y.to(u.dtype) @ p["wout"]
    return (out, h) if return_state else out


def mamba2_step(p, u, state, meta):
    """Single-token decode: u (B, 1, D), state (B, H, P, N) -> (y, state')."""
    B = u.shape[0]
    H, P = meta["n_heads"], meta["head_dim"]
    z, x, Bm, Cm, dt = _mamba2_split(p, u, meta)
    a = _decay(p, dt)[:, 0]                             # (B, H)
    xh = x.reshape(B, H, P).float()
    Bf, Cf = Bm[:, 0].float(), Cm[:, 0].float()
    state = state * a[..., None, None] + torch.einsum("bhp,bn->bhpn", xh, Bf)
    y = torch.einsum("bhpn,bn->bhp", state, Cf) + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, H * P) * F.silu(z.float())
    return y.to(u.dtype) @ p["wout"], state


def mamba2_init_state(B: int, meta, dtype=torch.float32, device=None):
    return torch.zeros((B, meta["n_heads"], meta["head_dim"],
                        meta["d_state"]), dtype=dtype, device=device)


# ===========================================================================
# RWKV6 (Finch) — data-dependent decay linear attention
# ===========================================================================

def init_rwkv6(gen, d_model: int, head_dim: int = 64, dtype=torch.float32):
    """Returns ``(params, meta)``."""
    H = d_model // head_dim
    dev = gen.device

    def lin(i, o):
        return _norm_init(gen, (i, o), i ** -0.5).to(dtype)

    params = {
        "w_rkvg": lin(d_model, 4 * d_model),  # fused r, k, v, gate: TM Split
        "w_decay": lin(d_model, d_model),
        "w_out": lin(d_model, d_model),
        "mu": torch.full((5, d_model), 0.5, dtype=torch.float32, device=dev),
        "u_bonus": torch.zeros((H, head_dim), dtype=torch.float32,
                               device=dev),
        "decay_base": torch.full((d_model,), -6.0, dtype=torch.float32,
                                 device=dev)}
    return params, dict(n_heads=H, head_dim=head_dim)


RWKV6_SPECS = {"w_rkvg": ("embed_fsdp", "heads"), "w_decay": ("embed", None),
               "w_out": ("heads", "embed_fsdp"), "mu": (None, None),
               "u_bonus": (None, None), "decay_base": (None,)}


def token_shift(x, x_prev=None):
    """TM Rearrange along time: x[t] -> x[t-1] (zero, or ``x_prev``, at
    t = 0)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _promoted(w, x):
    """``w`` in the type JAX promotes ``x @ w`` to (f32 mixes, bf16
    weights: f32)."""
    return w.to(torch.promote_types(x.dtype, w.dtype))


def _rwkv_bands(w, xs, layout: str, even: bool):
    """RWKV6's fused projection, TM Split into its four column bands:
    ``xs[b] @ w[:, b D:(b + 1) D]`` for the mixes r, k, v, g of ``xs`` and
    ``w_rkvg`` (D, 4 D), ``w`` cast as :func:`_promoted`.  Where the rules
    spread ``w``'s columns over ranks, a band's slice of them would gather
    the whole weight for each band.  Instead, as the block's
    :func:`band_layout` says, either (:data:`BANDS_WEIGHT`) the
    columns are gathered once, in their own dtype, and each band is
    sharded again over "heads" before its product, so that each rank
    computes its own heads of it (where the heads divide the ranks,
    ``even``: else the bands multiply whole, since :func:`_head_layout`
    pads whole heads); or (:data:`BANDS_PRODUCT`) each rank multiplies
    its own columns, cast there, by the mixes of the bands they belong
    to, in one ``local``, and the (B, S, 4 D) product is gathered once and
    split."""
    D = w.shape[0]
    if layout == BANDS_WEIGHT:
        w = _promoted(shard(w, ("embed_fsdp", None)), xs[0])
        cols = ("embed_fsdp", "heads" if even else None)
        return [x @ shard(w[:, b * D:(b + 1) * D], cols)
                for b, x in enumerate(xs)]
    if layout == BANDS_WHOLE:
        w = _promoted(w, xs[0])
        return [x @ w[:, b * D:(b + 1) * D] for b, x in enumerate(xs)]
    assert layout == BANDS_PRODUCT, layout
    cols, act = (None, "heads"), ("batch", None, None)
    lo, m = local_block(w.shape, cols, 1)

    def own(w, *xs):
        w = _promoted(w, xs[0])
        return torch.cat([x @ w[:, max(b * D, lo) - lo:
                                min((b + 1) * D, lo + m) - lo]
                          for b, x in enumerate(xs)
                          if b * D < lo + m and lo < (b + 1) * D], dim=-1)

    # w's gradient sums each rank's batch rows, a mix's its own columns
    prod = local(own, (cols,) + (act,) * len(xs), ("batch", None, "heads"),
                 in_grad=(with_partial(cols, "batch"),) +
                 (with_partial(act, "heads"),) * len(xs))(w, *xs)
    prod = shard(prod, act)
    return [prod[..., b * D:(b + 1) * D] for b in range(len(xs))]


def _rwkv_mix(p, x, shifted):
    mu = p["mu"]
    return tuple(x * mu[i] + shifted * (1 - mu[i]) for i in range(5))


def _wkv_steps(state, r, k, v, la, u):
    """The exact per-token recurrence; r, k, v, la (B, S, H, K) f32."""
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = state * torch.exp(la[:, t])[..., None] + kv
    return state, torch.stack(ys, dim=1)


def _wkv_chunk(s, rt, kt, vt, lat, u, tri):
    """One chunk of the chunked wkv recurrence (rt, kt, vt, lat (B, c, H,
    K) f32): separable in-chunk decays around the offset o = cl_c / 2."""
    cl = torch.cumsum(lat, dim=1)          # inclusive cumulative log-decay
    cl_prev = cl - lat                     # exclusive (cl_{t-1})
    cl_end = cl[:, -1:]                    # cl_c
    o = 0.5 * cl_end                       # stability offset
    r_t = rt * torch.exp(cl_prev - o)
    k_s = kt * torch.exp(o - cl)
    A = torch.einsum("bthk,bshk->bhts", r_t, k_s) * tri[None, None]
    diag = torch.einsum("bthk,bthk->bth", rt, u[None, None] * kt)
    y_intra = torch.einsum("bhts,bshv->bthv", A, vt) + diag[..., None] * vt
    r_dec = rt * torch.exp(cl_prev)
    y_inter = torch.einsum("bthk,bhkv->bthv", r_dec, s)
    k_tail = kt * torch.exp(cl_end - cl)
    s = s * torch.exp(cl_end[:, 0])[..., None] + \
        torch.einsum("bshk,bshv->bhkv", k_tail, vt)
    return s, y_intra + y_inter


def _head_layout(B: int, S: int, H: int, K: int, own: bool):
    """``(split, merge)``: (B, S, H K) -> (B, S, Hp, K) and back, Hp the
    heads the recurrence runs on.  Two views and Hp = H unless each rank
    runs ``own`` heads.  Then, the rules spreading them over n ranks,
    ``split`` lays the heads dim out over them, so that each rank runs
    the recurrence of its own heads
    (:func:`_wkv_own_heads`); if n does not divide H, a product's sharded
    H K dim would split heads between ranks, which DTensor cannot view,
    so ``split`` gathers the dim first, views it and pads the heads with
    zeros to Hp, the next multiple of n, as GSPMD pads them (40 heads over
    16 ranks: 48, 3 a rank, the last 8 zero: the same work a rank as
    uneven chunks of 3, but shards alike, which ``local_map`` needs), and
    ``merge`` gathers the heads and drops the padding before the view
    back.  A zero head (r, k, v 0, log-decay 0) keeps a zero state and
    gives 0."""
    n = ranks_of("heads")
    heads = ("batch", None, "heads", None)
    if not own:
        # sharded after the view back (a chunk, no traffic), so that a
        # gradient coming back sharded along H K is gathered before the
        # view's backward, which cannot split uneven heads
        return (lambda t: t.reshape(B, S, H, K),
                lambda t: shard(t.reshape(B, S, H * K),
                                ("batch", None, "heads")))
    if H % n == 0:
        return (lambda t: shard(t.reshape(B, S, H, K), heads),
                lambda t: t.reshape(B, S, H * K))
    Hp = -(-H // n) * n
    whole = ("batch", None, None, None)
    pad = local(lambda t: F.pad(t, (0, 0, 0, Hp - H)), (whole,), whole)

    def split(t):
        t = shard(t, ("batch", None, None)).reshape(B, S, H, K)
        return shard(pad(t), heads)

    def merge(t):
        t = shard(t, ("batch",) + (None,) * (t.ndim - 1))[..., :H, :]
        # sharded again after the view (a chunk, no traffic), so that the
        # gradient coming back, sharded along H K, is gathered before the
        # view's backward
        return shard(t.reshape(B, S, H * K), ("batch", None, "heads"))

    return split, merge


def _wkv_own_heads(state, r, k, v, la, u, chunk: int, chunked: bool):
    """:func:`_wkv` where the rules spread the heads (r, k, v, la (B, S,
    Hp, K), Hp of them, the last Hp - H zero) over ranks: each rank's
    recurrence over its own heads, as a ``local_map``, since DTensor
    (PyTorch 2.11's) cannot fold a sharded heads dim into a product's
    batch.  ``u`` (H, K) and ``state`` (B, H, K, K) come whole and each
    rank takes its own heads of them, zero past H; ``u``'s gradient is
    each rank's share, summed over the heads' and the batch's ranks.
    Returns ``(state
    (B, H, K, K), y)``, y laid out as r, chunked as :func:`_wkv`'s."""
    H, Hp = u.shape[0], r.shape[2]
    lo, n = local_block((Hp,), ("heads",), 0)
    heads = ("batch", None, "heads", None)
    whole = ("batch", None, None, None)

    def own(t, dim):
        if Hp > H:
            t = F.pad(t, (0, 0) * (t.ndim - dim - 1) + (0, Hp - H))
        return t.narrow(dim, lo, n)

    def run(state, r, k, v, la, u):
        return _wkv(None if state is None else own(state, 1), r, k, v, la,
                    own(u, 0), chunk, chunked)

    state, y = local(
        run, (None if state is None else whole, heads, heads, heads, heads,
              (None, None)),
        [("batch", "heads", None, None),
         ("batch", None, None, "heads", None) if chunked else heads],
        in_grad=(None, None, None, None, None,
                 with_partial((None, None), "heads", "batch")))(
        state, r, k, v, la, u)
    if Hp > H:
        state = shard(state, whole)[:, :H]
    return state, y


def _wkv(state, r, k, v, la, u, chunk: int, chunked: bool):
    """The wkv recurrence of r, k, v, la (B, S, H, K) f32 from ``state``
    (B, H, K, K; zero where None): ``(state, y)``, y (B, S, H, K) from the
    exact per-token recurrence, or, ``chunked``, (B, S // c, c, H, K) from
    the chunked one (c the largest divisor of S up to ``chunk``)."""
    B, S, H, K = r.shape
    if state is None:
        state = torch.zeros((B, H, K, K), dtype=torch.float32,
                            device=r.device)
    if not chunked:
        return _wkv_steps(state, r, k, v, la, u)
    c = chunk
    while S % c:
        c -= 1
    nc = S // c
    rc, kc, vc, lac = (t.reshape(B, nc, c, H, K) for t in (r, k, v, la))
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    ys = []
    for i in range(nc):
        state, yc = _wkv_chunk(state, rc[:, i], kc[:, i], vc[:, i],
                               lac[:, i], u, tri)
        ys.append(yc)
    return state, torch.stack(ys, dim=1)


def rwkv6_block(p, x, meta, *, x_prev=None, state=None, chunk: int = 64,
                stepwise: bool = False):
    """x: (B, S, D) -> ``(out (B, S, D), x[:, -1:], state (B, H, K, K)
    f32)``.  Chunked wkv recurrence by default; ``stepwise=True`` (and any
    S == 1) runs the exact per-token recurrence."""
    B, S, D = x.shape
    H, K = meta["n_heads"], meta["head_dim"]
    x = whole_seq(x)                  # the token shift reads neighbours
    shifted = token_shift(x, x_prev)
    xr, xk, xv, xg, xw = _rwkv_mix(p, x, shifted)
    # where the weight is split first, each rank runs the recurrence of
    # its own heads; uneven heads then gather the recurrence's output
    # (``merge``), which counts against the weight.  A product gathered
    # whole (a decode step's few rows) runs every head on every rank, so
    # that the state stays as whole as its slot and is never gathered
    even = H % ranks_of("heads") == 0
    layout = band_layout(p["w_rkvg"], xr, 0 if even else D, alike=True)
    own = layout == BANDS_WEIGHT
    r, k, v, g = _rwkv_bands(p["w_rkvg"], (xr, xk, xv, xg), layout, even)
    split, merge = _head_layout(B, S, H, K, own)
    r, k, v = split(r), split(k), split(v)
    w = -torch.exp(p["decay_base"] + (xw @ _promoted(p["w_decay"],
                                                     xw)).float())
    la = split(w)                          # log-decay (negative)
    r32, k32, v32 = r.float(), k.float(), v.float()
    chunked = not (stepwise or S == 1)
    wkv = _wkv_own_heads if own else _wkv
    state, ys = wkv(state, r32, k32, v32, la, p["u_bonus"], chunk, chunked)
    y = merge(ys)

    y = y * F.silu(g.float())
    out = y.to(x.dtype) @ p["w_out"]
    return out, x[:, -1:], state


def rwkv6_step(p, x, x_prev, state, meta):
    """Single-token decode: x (B, 1, D)."""
    return rwkv6_block(p, x, meta, x_prev=x_prev, state=state)


def init_rwkv_ffn(gen, d_model: int, d_ff: int, dtype=torch.float32):
    return {"wk": _norm_init(gen, (d_model, d_ff), d_model ** -0.5).to(dtype),
            "wv": _norm_init(gen, (d_ff, d_model), d_ff ** -0.5).to(dtype),
            "mu": torch.full((d_model,), 0.5, dtype=torch.float32,
                             device=gen.device)}


RWKV_FFN_SPECS = {"wk": ("embed_fsdp", "mlp"), "wv": ("mlp", "embed_fsdp"),
                  "mu": (None,)}


def rwkv_ffn(p, x, x_prev=None):
    x = whole_seq(x)                  # the token shift reads neighbours
    shifted = token_shift(x, x_prev)
    xm = (x * p["mu"] + shifted * (1 - p["mu"])).to(x.dtype)
    h = torch.square(torch.relu(xm @ p["wk"]))
    return (h @ p["wv"]).to(x.dtype), x[:, -1:]
