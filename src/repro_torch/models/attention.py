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
(longer prefill).  It is chosen only by that argument, never by a failure.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.executor import resolve_device
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_decode)
from repro_torch.models.layers import _norm_init, apply_rope

NEG_INF = -1e30
ATTENTION = ("flash", "plain")


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype=torch.float32):
    fused = (n_heads + 2 * n_kv) * head_dim
    wqkv = _norm_init(gen, (d_model, fused), d_model ** -0.5).to(dtype)
    wo = _norm_init(gen, (n_heads * head_dim, d_model),
                    (n_heads * head_dim) ** -0.5).to(dtype)
    return {"wqkv": wqkv, "wo": wo}


def qkv_split(p, x, n_heads: int, n_kv: int, head_dim: int):
    """Fused projection + TM Split + head-layout reshape: q, k, v are views
    of the one product (B, S, (H + 2 KV) Hd)."""
    qkv = x @ p["wqkv"]
    B, S, _ = qkv.shape
    q_end = n_heads * head_dim
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


def attention_block(p, x, inv_freq, *, n_heads: int, n_kv: int,
                    head_dim: int, positions=None, cache=None,
                    cache_index: int | None = None, causal: bool = True,
                    chunk: int = 1024, attention: str = "flash",
                    inplace: bool = True):
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
    S``, unclamped, as in JAX.  Returns ``(out, new_cache)``.
    """
    if attention not in ATTENTION:
        raise ValueError(f"attention must be one of {ATTENTION}, got "
                         f"{attention!r}")
    flash = attention == "flash"
    B, S, _ = x.shape
    q, k, v = qkv_split(p, x, n_heads, n_kv, head_dim)
    if positions is None:
        base = 0 if cache_index is None else cache_index
        positions = (base + torch.arange(S, device=x.device)).expand(B, S)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)

    new_cache = None
    if cache is not None:
        # TM Route: write the new band into the KV cache at cache_index
        start = band_start(cache_index, cache["k"].shape[1], S)
        if inplace:
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
            out = (flash_decode(q, ck, cv, kv_len) if flash
                   else full_attention(q, ck, cv, causal=False,
                                       kv_len=kv_len))
            return out.reshape(B, S, n_heads * head_dim) @ p["wo"], new_cache
        # prefill: causal within the fresh segment (the cache is empty
        # before cache_index == 0)
    if flash:
        out = flash_attention(q, k, v, causal=causal)
    elif S > 2048:
        out = chunked_attention(q, k, v, causal=causal, chunk=chunk)
    else:
        out = full_attention(q, k, v, causal=causal)
    return out.reshape(B, S, n_heads * head_dim) @ p["wo"], new_cache


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
