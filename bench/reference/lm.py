"""Plain float32 reference of the decoder the configurations run: dense
(GQA attention + SwiGLU) and MoE (the same attention + top-k routed
SwiGLU experts with a per-sequence capacity, plus one shared expert),
its next-token loss, and AdamW.

Plain ``torch`` operations only, TF32 off: no kernel, cache or batching of
the program under test, and nothing imported from it.  It follows the
configuration as run (``run_as`` in its file); where that departs from the
published model the file lists it under ``assumed``.

Every product goes through ``mm``: :data:`EXACT` (float32), or
:data:`FP8`, the control, which rounds both operands to float8 (e4m3, one
scale a tensor; the gradients of the backward pass to e5m2) before an
exact product, as an fp8 path of the program would.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

QUERY_BLOCK = 1024   # query rows of one attention product


def exact_float32():
    """TF32 off for every float32 product and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, fmt) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).to(torch.float32) * scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def EXACT(a, b):
    return a @ b


def FP8(a, b):
    return _Fp8Product.apply(a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rmsnorm(x, g, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x, pos, theta: float):
    """Rotary embedding over the whole head, the halves rotated as pairs.
    x (B, S, H, hd); pos (S,) integer positions."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(d, w, x, pos, past, mm):
    """Causal GQA attention of the S new positions ``pos`` over ``past``
    ((k, v), each (B, T0, KV, hd), the positions before them) and
    themselves."""
    B, S, _ = x.shape
    H, KV, hd = d.H, d.KV, d.hd
    qkv = mm(x, w["attn.wqkv"])
    q = qkv[..., :H * hd].reshape(B, S, H, hd)
    k = qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd)
    v = qkv[..., (H + KV) * hd:].reshape(B, S, KV, hd)
    q, k = rope(q, pos, d.theta), rope(k, pos, d.theta)
    if past is not None:
        k = torch.cat([past[0], k], dim=1)
        v = torch.cat([past[1], v], dim=1)
    T = k.shape[1]
    G = H // KV
    qh = q.transpose(1, 2)                                   # (B, H, S, hd)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)       # (B, H, T, hd)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    keys = torch.arange(T, device=x.device)
    outs = []
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(S, lo + QUERY_BLOCK)
        s = mm(qh[:, :, lo:hi], kh.transpose(-1, -2)) / math.sqrt(hd)
        rows = (T - S) + torch.arange(lo, hi, device=x.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        outs.append(mm(torch.softmax(s, dim=-1), vh))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)
    return mm(o, w["attn.wo"])


def swiglu(x, wi, wo, mm):
    g, u = mm(x, wi).chunk(2, dim=-1)
    return mm(F.silu(g) * u, wo)


def moe(d, w, x, mm):
    """Top-k routing over the E published experts (softmax, the k largest
    by a stable sort, renormalised), each expert keeping the first C of
    the sequence's assignments in (token, rank) order, C =
    min(int(capacity_factor * S * k / E) + 1, S); plus the shared expert.
    Returns (out, load balance)."""
    B, S, D = x.shape
    E, k = d.E, d.k
    probs = torch.softmax(mm(x, w["moe.router"]), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert = top.values[..., :k], top.indices[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    C = min(int(d.capacity_factor * S * k / E) + 1, S)
    flat = expert.reshape(B, S * k)
    rank = torch.cumsum(F.one_hot(flat, E), dim=1) - 1
    kept = rank.gather(2, flat[..., None])[..., 0] < C
    gflat = gates.reshape(B, S * k)
    out = torch.zeros_like(x)
    for e in range(E):
        b, a = ((flat == e) & kept).nonzero(as_tuple=True)
        if b.numel() == 0:
            continue
        s = a // k
        y = swiglu(x[b, s], w["moe.wi"][e], w["moe.wo"][e], mm)
        out = out.index_put((b, s), y * gflat[b, a][:, None],
                            accumulate=True)
    out = out + swiglu(x, w["moe.shared.wi"], w["moe.shared.wo"], mm)
    me = F.one_hot(expert[..., 0], E).float().mean(dim=(0, 1))
    lb = E * torch.sum(me * probs.mean(dim=(0, 1)))
    return out, lb


def block(d, w, x, pos, past, mm):
    """One pre-norm layer; ``w`` maps ``attn.wqkv``... to this layer's
    float32 weights.  Returns (x, load balance or None)."""
    x = x + attention(d, w, rmsnorm(x, w["ln1.g"], d.eps), pos, past, mm)
    h = rmsnorm(x, w["ln2.g"], d.eps)
    if d.moe:
        m, lb = moe(d, w, h, mm)
        return x + m, lb
    return x + swiglu(h, w["mlp.wi"], w["mlp.wo"], mm), None


def head(d, final_g, table, x, mm):
    """Logits over the vocabulary: the final norm, then the tied table."""
    return mm(rmsnorm(x, final_g, d.eps), table.T)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def layer_view(P: dict, layer: int) -> dict:
    """This layer's weights of the flat leaf dict ``P`` (its
    ``blocks.<leaf>.<layer>`` keys), under the names :func:`block`
    reads."""
    tail = f".{layer}"
    return {k[len("blocks."):-len(tail)]: v for k, v in P.items()
            if k.startswith("blocks.") and k.endswith(tail)}


def loss(d, P: dict, tokens, labels, mm):
    """Mean next-token cross entropy, plus ``aux_coef`` x the load balance
    averaged over the layers for MoE."""
    x = P["embed.e"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    lbs = []
    for i in range(d.L):
        x, lb = block(d, layer_view(P, i), x, pos, None, mm)
        lbs.append(lb)
    logits = head(d, P["final_norm.g"], P["embed.e"], x, mm)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1).long())
    if d.moe:
        ce = ce + d.aux_coef * torch.stack(lbs).mean()
    return ce


def cosine_lr(step: int, *, peak_lr: float, warmup: int, total: int,
              min_ratio: float = 0.1) -> float:
    """The learning rate of the step count before the update: linear
    warmup, then a cosine decay to ``min_ratio`` of the peak."""
    if step < warmup:
        return peak_lr * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                      (1 + math.cos(math.pi * prog)))


def train(d, P: dict, batches, hp: dict, mm, initial) -> dict:
    """AdamW over ``P`` (float32 leaves, updated in place) for each of
    ``batches`` ((tokens, labels)), global-norm clipping first.  Returns
    each step's loss, each leaf's norm of the first step's clipped
    gradient, and each leaf's norm of its change over all the steps
    (``initial(name)`` draws a leaf's starting value again)."""
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    names = list(P)
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    losses, first = [], {}
    for t, (tokens, labels) in enumerate(batches, start=1):
        for n in names:
            P[n].requires_grad_(True)
        value = loss(d, P, tokens, labels, mm)
        grads = torch.autograd.grad(value, [P[n] for n in names])
        losses.append(float(value.detach()))
        with torch.no_grad():
            gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(hp["max_norm"] / torch.clamp(gn, min=1e-9),
                                max=1.0)
            lr = cosine_lr(t - 1, peak_lr=hp["peak_lr"],
                           warmup=hp["warmup"], total=hp["total"])
            for n, g in zip(names, grads):
                p = P[n].detach()
                g = g * scale
                if t == 1:
                    first[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[n] / (1 - b1 ** t)) / (
                    torch.sqrt(v[n] / (1 - b2 ** t)) + eps) + wd * p
                p.sub_(lr * upd)
            del grads, g
    del m, v
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(P[n].detach() -
                                                    initial(n)))
                  for n in names}
    return {"loss": losses, "first_grad": first, "change": change}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_logits(d, layer_weights, table, final_g, seqs, mms, *,
                 last_only: bool):
    """Layer by layer (each layer's weights drawn once by
    ``layer_weights(i)``), the logits of every sequence under every
    product in ``mms``.  ``seqs`` holds ``(tokens (B, S), pos (S,),
    past(i) -> (k, v) or None)``.  Returns ``[mm][seq] -> logits (B, S or
    1, V)``."""
    xs = [[table[tokens] for tokens, _, _ in seqs] for _ in mms]
    for i in range(d.L):
        w = layer_weights(i)
        for j, mm in enumerate(mms):
            for s, (_, pos, past) in enumerate(seqs):
                xs[j][s] = block(d, w, xs[j][s], pos,
                                 None if past is None else past(i), mm)[0]
        del w
    return [[head(d, final_g, table, x[:, -1:] if last_only else x, mm)
             for x in row] for mm, row in zip(mms, xs)]
