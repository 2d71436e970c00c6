"""GQA attention assembled from TM ops + online-softmax attention.

The JAX package's ``models/attention.py`` with PyTorch tensors.  TM-layer
reading of each step, as there:
  * fused QKV projection -> **Split** (three views of one product);
  * (B, S, H*Hd) -> (B, S, H, Hd) head layout -> coarse TM reshape (views);
  * KV-cache append at the decode position -> **Route** (band write);
  * GQA KV broadcast kv -> q heads -> **Upsample** along the head axis,
    composed into the attention's addressing: the kernels read KV head
    ``h // G`` for query head h, so the repeat costs no memory traffic;
  * online-softmax streaming over KV blocks -> the RME *evaluate* scheme
    generalized to running max/sum.

:func:`attention_block` takes ``attention="flash"`` (the default) or
``"plain"``.  Flash sends prefill to :func:`flash_attention` and a decode
step (S == 1 with a cache) to :func:`flash_decode`: on the card the
hand-written kernels, on the CPU their plain versions.  Plain runs the JAX
package's own jnp path, ported: :func:`full_attention` (prefill up to 2048
tokens, and decode under a ``kv_len`` mask) and :func:`chunked_attention`
or, with ``triangular``, :func:`chunked_attention_triangular` (longer
prefill).  It is chosen only by that argument, never by a failure.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.executor import resolve_device
from repro_torch.kernels.flash_attention.flash_attention import (
    combine_partials, flash_attention, flash_decode, flash_decode_partial,
    prefill_op)
from repro_torch.models.layers import _norm_init, apply_rope
from repro_torch.runtime.sharding import (BANDS_WEIGHT, all_reduce_over,
                                          band_layout, local, local_block,
                                          ranks_of, shard, spec_of,
                                          whole_seq, with_partial)

NEG_INF = -1e30
ATTENTION = ("flash", "plain")


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype=torch.float32):
    fused = (n_heads + 2 * n_kv) * head_dim
    wqkv = _norm_init(gen, (d_model, fused), d_model ** -0.5).to(dtype)
    wo = _norm_init(gen, (n_heads * head_dim, d_model),
                    (n_heads * head_dim) ** -0.5).to(dtype)
    return {"wqkv": wqkv, "wo": wo}


ATTENTION_SPECS = {"wqkv": ("embed_fsdp", "heads"),
                   "wo": ("heads", "embed_fsdp")}


def qkv_split(p, x, n_heads: int, n_kv: int, head_dim: int,
              layout: str | None = None):
    """Fused projection + TM Split + head-layout reshape: q, k, v are views
    of the one product (B, S, (H + 2 KV) Hd).

    Under rules that spread the heads over more than one rank, the
    product's shards do not end at the bands' edges, so it is gathered
    whole, once (a slice of its sharded dim would gather it for each
    band), and every head then runs on every rank.  Where that activation
    gather would move more than a gather of the weight (``layout``, the
    block's :func:`band_layout`, computed here where None, is
    :data:`BANDS_WEIGHT`), the split comes first instead: ``wqkv``'s
    columns are gathered once, q is the product of x with its q band
    sharded as "heads", so each rank computes its own heads, as GSPMD
    keeps them (gathered after the product where they do not divide the
    ranks), and k and v come from one product with the k and v bands,
    sharded then gathered as "kv_heads" lays them out."""
    q_end = n_heads * head_dim
    if layout is None:
        layout = band_layout(p["wqkv"], x, p["wqkv"].shape[1] - q_end,
                             alike=False)
    if layout == BANDS_WEIGHT:
        x = whole_seq(x)
        B, S, _ = x.shape
        w = shard(p["wqkv"], ("embed_fsdp", None))
        q = x @ shard(w[:, :q_end], ("embed_fsdp", "heads"))
        even = n_heads % ranks_of("heads") == 0
        q = shard(q, ("batch", None, "heads" if even else None))
        kv = x @ shard(w[:, q_end:], ("embed_fsdp", "heads"))
        kv = shard(kv, ("batch", None, "kv_heads"))
        k, v = torch.chunk(kv, 2, dim=-1)
        return (q.view(B, S, n_heads, head_dim),
                k.view(B, S, n_kv, head_dim), v.view(B, S, n_kv, head_dim))
    qkv = shard(whole_seq(x) @ p["wqkv"], ("batch", None, "heads"))
    qkv = shard(qkv, ("batch", None, None))      # gathered once, then split
    B, S, _ = qkv.shape
    k_end = q_end + n_kv * head_dim
    q = qkv[..., :q_end].view(B, S, n_heads, head_dim)       # TM Split band 0
    k = qkv[..., q_end:k_end].view(B, S, n_kv, head_dim)     # band 1
    v = qkv[..., k_end:].view(B, S, n_kv, head_dim)          # band 2
    return q, k, v


def _grouped_scores(q, k, scale):
    """q: (B, S, KV, G, D); k: (B, T, KV, D) -> (B, KV, G, S, T) in f32
    (bf16 products are exact in f32, as preferred_element_type=f32)."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024):
    """Online-softmax attention over KV chunks (the JAX package's scan, as
    a Python loop).  q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KV, G, D)
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    m = torch.full((B, KV, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, G, S), device=q.device)
    acc = torch.zeros((B, KV, G, S, D), device=q.device)
    q_pos = torch.arange(S, device=q.device)
    for ci in range(T // chunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        s = _grouped_scores(qg, kb, scale)          # (B, KV, G, S, chunk)
        if causal:
            kpos = ci * chunk + torch.arange(chunk, device=q.device)
            s = s.masked_fill(q_pos[:, None] < kpos[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                    vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B, KV, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def chunked_attention_triangular(q, k, v, *, chunk: int = 1024):
    """Causal online-softmax attention over the lower triangle only: the
    nc(nc+1)/2 live score blocks of the chunk grid (the diagonal blocks
    keep the in-block causal mask), the same numerics as
    :func:`chunked_attention`.  Past 16 chunks a row, the JAX package
    bounds its unrolled program and scans instead, and so does this."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, S)
    while S % chunk or T % chunk:
        chunk -= 1
    nc = S // chunk
    if nc > 16:
        return chunked_attention(q, k, v, causal=True, chunk=chunk)
    qg = q.reshape(B, nc, chunk, KV, G, D)
    kc = k.reshape(B, nc, chunk, KV, D)
    vc = v.reshape(B, nc, chunk, KV, D)
    diag = torch.arange(chunk, device=q.device)
    below = diag[:, None] >= diag[None, :]
    outs = []
    for i in range(nc):
        m = torch.full((B, KV, G, chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, chunk), device=q.device)
        acc = torch.zeros((B, KV, G, chunk, D), device=q.device)
        for j in range(i + 1):                     # lower triangle only
            s = _grouped_scores(qg[:, i], kc[:, j], scale)
            if j == i:  # diagonal block: in-block causal mask
                s = s.masked_fill(~below, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p, vc[:, j].float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)                 # (B, nc, KV, G, c, D)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, D).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, kv_len=None):
    """Materialized path (the JAX package's for S <= 2048 and decode): the
    scores in f32, the probabilities rounded to v's dtype before the PV
    product, which sums in f32."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    s = _grouped_scores(q.reshape(B, S, KV, G, D), k.to(q.dtype), scale)
    if causal:
        pos = torch.arange(max(S, T), device=q.device)
        s = s.masked_fill(pos[:S, None] < pos[None, :T], NEG_INF)
    if kv_len is not None:
        s = s.masked_fill(torch.arange(T, device=q.device) >= kv_len, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def band_start(cache_index: int, T: int, S: int) -> int:
    """Where a band of S rows lands in a T-row cache when asked for
    ``cache_index``: ``lax.dynamic_update_slice``'s rule, which wraps a
    negative start once (start + T) and then clamps it into [0, T - S], so
    the band always lies whole inside the cache."""
    start = cache_index + T if cache_index < 0 else cache_index
    return min(max(start, 0), T - S)


CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)


def _rows_spread() -> bool:
    """Whether the rules spread a cache's rows over a mesh axis
    (``kv_seq``: "model" in decode, "data" in long-context decode)."""
    spec = spec_of(("kv_seq",))
    return bool(spec) and spec[0] is not None


def _band_write(c, t, start: int, inplace: bool):
    """The band ``t`` (B, S, KV, D) into rows [start, start + S) of the
    cache ``c`` whose rows the rules spread over ranks: each rank writes
    the part of the band that falls in its own block of rows, at its own
    coordinates, and moves nothing (the block's offset is the host's).  In
    place into ``c``'s shards, or, without ``inplace``, into a new cache
    (``slice_scatter``)."""
    S = t.shape[1]
    offset, rows = local_block(c.shape, CACHE_AXES, 1)
    lo = min(max(start, offset), offset + rows)
    hi = max(min(start + S, offset + rows), lo)

    def write(c, t):
        band = t[:, lo - start:hi - start].to(c.dtype)
        if inplace:
            c[:, lo - offset:hi - offset] = band
            return c
        return torch.slice_scatter(c, band, dim=1, start=lo - offset,
                                   end=hi - offset)

    return local(write, (CACHE_AXES, ("batch", None, "kv_heads", None)),
                 CACHE_AXES)(c, t)


def _decode_over_rows(q, ck, cv, kv_len: int):
    """:func:`flash_decode` against a cache whose rows the rules spread
    over ranks, GSPMD's distributed flash decode: each rank runs
    :func:`flash_decode_partial` on its own rows, up to its local length
    ``clamp(kv_len - offset, 0, rows)`` (a rank with none gives ``o = 0,
    lse = -inf``), and the ranks combine their ``(o, lse)`` as the
    decode kernel combines its splits (:func:`combine_partials`): an
    all-reduce of the max of lse, then one of the weighted o and the
    weights, B x H x (D + 1) floats whatever the cache's length.  q's
    heads are gathered first, since each rank holds every KV head of its
    rows."""
    offset, rows = local_block(ck.shape, CACHE_AXES, 1)
    length = max(0, min(kv_len - offset, rows))

    def attend(q, k, v):
        o, lse = flash_decode_partial(q, k, v, length)
        return combine_partials(
            o, lse, q.dtype,
            amax=lambda t: all_reduce_over(t, "max", "kv_seq"),
            total=lambda t: all_reduce_over(t, "sum", "kv_seq"))

    whole = ("batch", None, None, None)
    return local(attend, (whole, CACHE_AXES, CACHE_AXES), whole)(q, ck, cv)


def attention_block(p, x, inv_freq, *, n_heads: int, n_kv: int,
                    head_dim: int, positions=None, cache=None,
                    cache_index: int | None = None, causal: bool = True,
                    chunk: int = 1024, attention: str = "flash",
                    inplace: bool = True, triangular: bool = False):
    """Full attention block.  With ``cache`` (serving): append the new K/V
    at ``cache_index`` (TM Route band write) and attend to the cache.

    With ``inplace`` (the serve loop) the band is written into the caller's
    ``cache`` tensors, where the JAX package builds a new cache with
    ``dynamic_update_slice``: its serve loop donates the caches, so nothing
    observable changes, and the returned cache is the same dict.  Without
    it the new caches are built with ``torch.slice_scatter`` (the
    functional form ``make_fx``, ``tm_compile`` and ``torch.func.vmap``
    take, which the compiler matches as an overlay Route) and the caller's
    tensors are left as they were.  The band lands at
    :func:`band_start` (a start past the cache or below 0 is wrapped and
    clamped as lax does), while the decode length stays ``cache_index +
    S``, unclamped, as in JAX.  ``triangular`` (the ``attn_impl``
    of MoE configs) sends a plain causal prefill past 2048 tokens to
    :func:`chunked_attention_triangular`, as the JAX package does; the
    flash prefill ignores it.  Returns ``(out, new_cache)``.
    """
    if attention not in ATTENTION:
        raise ValueError(f"attention must be one of {ATTENTION}, got "
                         f"{attention!r}")
    flash = attention == "flash"
    B, S, _ = x.shape
    layout = band_layout(p["wqkv"], x, p["wqkv"].shape[1] -
                         n_heads * head_dim, alike=False)
    q, k, v = qkv_split(p, x, n_heads, n_kv, head_dim, layout)
    if positions is None:
        base = 0 if cache_index is None else cache_index
        positions = (base + torch.arange(S, device=x.device)).expand(B, S)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)

    new_cache = None
    if cache is not None:
        # TM Route: write the new band into the KV cache at cache_index
        start = band_start(cache_index, cache["k"].shape[1], S)
        rows = _rows_spread()
        if rows:
            new_cache = {n: _band_write(cache[n], t, start, inplace)
                         for n, t in (("k", k), ("v", v))}
            if inplace:
                new_cache = cache
        elif inplace:
            cache["k"][:, start:start + S] = k
            cache["v"][:, start:start + S] = v
            new_cache = cache
        else:
            new_cache = {n: torch.slice_scatter(
                cache[n], t.to(cache[n].dtype), dim=1, start=start,
                end=start + S) for n, t in (("k", k), ("v", v))}
        if S == 1:
            kv_len = cache_index + S
            ck, cv = new_cache["k"], new_cache["v"]
            if rows and flash:
                out = _decode_over_rows(q, ck, cv, kv_len)
            elif flash:
                out = flash_decode(q, ck, cv, kv_len)
            else:
                out = full_attention(q, ck, cv, causal=False, kv_len=kv_len)
            return _out_proj(p, out.reshape(B, S, n_heads * head_dim)), \
                new_cache
        # prefill: causal within the fresh segment (the cache is empty
        # before cache_index == 0)
    if flash:
        attend = lambda q, k, v: _flash(q, k, v, causal)  # noqa: E731
    elif S > 2048 and causal and triangular:
        attend = lambda q, k, v: chunked_attention_triangular(  # noqa: E731
            q, k, v, chunk=chunk)
    elif S > 2048:
        attend = lambda q, k, v: chunked_attention(  # noqa: E731
            q, k, v, causal=causal, chunk=chunk)
    else:
        attend = lambda q, k, v: full_attention(  # noqa: E731
            q, k, v, causal=causal)
    if layout == BANDS_WEIGHT and n_heads % ranks_of("heads") == 0:
        out = _own_heads(attend, q, k, v, n_heads // n_kv)
    else:
        out = attend(q, k, v)
    return _out_proj(p, out.reshape(B, S, n_heads * head_dim)), new_cache


def _flash(q, k, v, causal: bool):
    """:func:`flash_attention`; a rank's meta shards (the dry-run, inside
    :func:`_own_heads`' ``local_map``) through its custom op, whose fake
    gives the shape."""
    if q.is_meta:
        return prefill_op(q, k, v, causal, None)
    return flash_attention(q, k, v, causal=causal)


def _own_heads(attend, q, k, v, G: int):
    """``attend(q, k, v)`` where q's heads lie over ranks and k and v are
    whole (:func:`qkv_split`'s split-first layout): each rank attends with
    its own query heads over the KV heads they read (a view where its
    heads hold whole groups of G, else those heads gathered), as a
    ``local_map``, so that no product folds a sharded heads dim into its
    batch (which PyTorch 2.11's DTensor refuses) and the heads are never
    gathered.  The gradients of k and v are each rank's share, summed
    over the heads' ranks."""
    heads = ("batch", None, "heads", None)
    kv = ("batch", None, "kv_heads", None)
    lo, n = local_block(q.shape, heads, 2)

    def local_attend(q, k, v):
        if lo % G == 0 and n % G == 0:
            k, v = (t[:, :, lo // G:(lo + n) // G] for t in (k, v))
        else:
            own = torch.arange(lo, lo + n, device=q.device) // G
            k, v = k[:, :, own], v[:, :, own]
        return attend(q, k, v)

    return local(local_attend, (heads, kv, kv), heads,
                 in_grad=(None, with_partial(kv, "heads"),
                          with_partial(kv, "heads")))(q, k, v)


def _out_proj(p, out):
    """The output projection, its input laid out as ``wo``'s rows (heads
    over "model" under the rules): a row-parallel product, its input a
    local chunk of heads the attention computed whole, or its own heads
    where the attention kept them sharded."""
    return shard(out, ("batch", None, "heads")) @ p["wo"]


def cached_attention_step(p, x, inv_freq, cache_k, cache_v, *,
                          n_heads: int, n_kv: int, head_dim: int,
                          position: int, attention: str = "plain"):
    """Static-position cached attention for the TMU serving path.

    ``position`` is a Python int (coerced here): closed over the traced
    function, the KV append is a ``slice_scatter`` at a constant start —
    the form the compiler matches as an overlay Route TM instruction — and
    the RoPE angles fold to trace-time constants.  The caches are not
    written in place: new ones are built and returned (flat, vmap and
    submit friendly) as ``(out, new_cache_k, new_cache_v)``.  The attention
    itself is a compute node, as in the JAX step (``full_attention``):
    ``attention="plain"``."""
    out, new_cache = attention_block(
        p, x, inv_freq, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
        cache={"k": cache_k, "v": cache_v}, cache_index=int(position),
        attention=attention, inplace=False)
    return out, new_cache["k"], new_cache["v"]


def init_cache(B: int, max_len: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed K and V caches (B, max_len, KV, Hd), two tensors, since the
    blocks write them in place.  ``device`` None means the card."""
    dev = resolve_device(device)
    shape = (B, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
