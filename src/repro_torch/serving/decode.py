"""Position-bucketed LM decode through the TMU serving runtime.

The JAX package's ``serving/decode.py`` with PyTorch tensors.  LM decode is
the manipulation-heaviest traffic the repo models — the KV-cache append,
the head split and merge, RoPE's slices and concatenation — and this module
routes it through ``TMServer``/``tm_compile``.  The decode *position* is
treated exactly like a shape: each position gets its own step function (the
position is a Python-int closure constant, so the KV append is a
``slice_scatter`` at a constant start and the RoPE angles fold to register
constants) and its own ``fn_key``, so the compile cache holds one pinned
program per ``(position, seq_len)`` class and replays it for every request
that lands there.

The served unit is one decoder layer of the model (embed → block 0 → final
norm → logits): the KV cache rides the request path — each response returns
the appended cache, the next step submits it back — so a session flows
through the compile cache without a server-side state store.  Every pinned
program closes over the same parameter tensors (``tm_compile`` keeps
closed-over tensors as they are), so the weights exist once however many
positions are compiled.

A session-owned server runs the ``cuda`` backend (the TM kernels on the
card, their plain versions on the CPU) with ``max_batch=4``,
``batch_timeout_s=0``, ``cache_capacity = max_len + 8`` and
``exact=True``, on the session's ``device`` (None means the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core.executor import resolve_device
from repro_torch.models.attention import cached_attention_step
from repro_torch.models.layers import embed, mlp, rmsnorm, rope_freqs, unembed
from repro_torch.models.transformer import ModelConfig, init_lm
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerDetector
from repro_torch.serving.server import ServerConfig, TMServer
from repro_torch.serving.stats import latency_percentiles
from repro_torch.tree import tree_map


def make_layer_step(cfg: ModelConfig, params, *, position: int):
    """One serving step of decoder layer 0 at static ``position``.

    Returns a pure ``step(tokens, cache_k, cache_v) -> (logits, ck, cv)``
    closing over the parameters and the *Python-int* position: the KV
    append is a ``slice_scatter`` at a constant start (matched as an
    overlay Route TM instruction) and the RoPE position and angle
    arithmetic constant-folds at trace time.  ``tokens`` is ``(B, S)``
    int32 (S == 1 for decode, the prompt length for prefill); the caches
    are ``(B, max_len, n_kv, head_dim)``.  The caller's caches are never
    written: new ones are returned."""
    position = int(position)
    block = tree_map(lambda t: t[0], params["blocks"])
    inv_freq = rope_freqs(cfg.hd, cfg.rope_theta,
                          device=params["embed"]["e"].device)

    def step(tokens, cache_k, cache_v):
        x = embed(params["embed"], tokens)
        h, ck, cv = cached_attention_step(
            block["attn"], rmsnorm(block["ln1"], x), inv_freq, cache_k,
            cache_v, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, position=position)
        x = x + h                                  # TM Add (residual)
        x = x + mlp(block["mlp"], rmsnorm(block["ln2"], x))
        x = rmsnorm(params["final_norm"], x)
        return unembed(params["embed"], x, cfg.vocab), ck, cv

    return step


@dataclasses.dataclass
class DecodeStats:
    """Per-session accounting next to the server's own snapshot."""

    prefill_steps: int = 0
    decode_steps: int = 0
    positions_compiled: int = 0
    speculated_positions: int = 0      # next-position prewarms scheduled
    slow_steps: int = 0                # straggler-flagged decode steps
    prefill_latency_s: list = dataclasses.field(default_factory=list)
    step_latency_s: list = dataclasses.field(default_factory=list)

    def snapshot(self) -> dict:
        """Counts + per-decode-step / prefill latency percentiles."""
        return {
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "positions_compiled": self.positions_compiled,
            "speculated_positions": self.speculated_positions,
            "slow_steps": self.slow_steps,
            **latency_percentiles(self.prefill_latency_s, "prefill_latency"),
            **latency_percentiles(self.step_latency_s, "step_latency"),
        }


class DecodeSession:
    """Prefill + incremental decode of one decoder layer via ``TMServer``.

    Every step goes through ``server.submit`` with a position-qualified
    ``fn_key``: the first request at a ``(position, seq_len)`` class pays
    the ``tm_compile`` of ``torch.func.vmap(step)``; every later one
    replays the cached program.  The KV cache is carried across steps
    through the request path (response → next submit), never stored
    server-side.

    ``params`` None draws the model's parameters from ``generator`` (a
    ``torch.Generator``; None means one on ``device`` seeded with 0).
    ``device`` None means the card."""

    def __init__(self, cfg: ModelConfig, params=None, *, max_len: int = 64,
                 server: TMServer | None = None,
                 config: ServerConfig | None = None,
                 generator: torch.Generator | None = None, device=None,
                 priority: str = "interactive",
                 deadline_s: float | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = init_lm(cfg, generator, device=self.device)
        self.params = params
        self.max_len = int(max_len)
        self._own_server = server is None
        if server is None:
            # one cache entry per decode position: capacity must cover the
            # whole session or the LRU would recompile every generation
            # pass.  exact=True: decode gates on bit-exact caches and logits
            # against the eager model.  max_batch > 1: a lone session still
            # runs height-1 groups; concurrent sessions at one position
            # class coalesce
            config = config or ServerConfig(
                backend="cuda", max_batch=4, batch_timeout_s=0.0,
                cache_capacity=self.max_len + 8, exact=True,
                device=self.device)
            server = TMServer(config).start()
        self.server = server
        self.priority = priority          # class for every step
        self.deadline_s = deadline_s      # per-STEP relative deadline
        self.stats = DecodeStats()
        # liveness over STEP walls: the heartbeat beats on every completed
        # step and the straggler detector flags outlier decode steps (its
        # warmup absorbs the first compile-heavy positions)
        self.heartbeat = Heartbeat(deadline_s=30.0)
        self.straggler = StragglerDetector(threshold=3.0)
        self._steps: dict[int, Any] = {}
        self._cache_dtype = (torch.float32 if cfg.dtype == torch.float32
                             else torch.bfloat16)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._own_server:
            self.server.stop()

    def __enter__(self) -> "DecodeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the step path -----------------------------------------------------

    def _fn_key(self, position: int, seq_len: int) -> str:
        # the position IS part of the bucket identity, like a shape class
        return f"{self.cfg.name}/decode-layer@p{position}s{seq_len}"

    def step_fn(self, position: int):
        """The (memoized) pure step function at ``position`` — also the
        bit-exactness oracle: calling it eagerly is the uncompiled
        model."""
        if position not in self._steps:
            self._steps[position] = make_layer_step(self.cfg, self.params,
                                                    position=position)
            self.stats.positions_compiled += 1
        return self._steps[position]

    def init_cache(self, batch: int):
        z = torch.zeros((batch, self.max_len, self.cfg.n_kv_heads,
                         self.cfg.hd), dtype=self._cache_dtype,
                        device=self.device)
        return z, z

    def prefill(self, prompts: torch.Tensor):
        """Run the prompt through the layer at position 0.

        ``prompts``: (B, S) int32.  Returns ``(logits, (cache_k,
        cache_v))`` with the prompt's K/V appended at positions
        ``[0, S)``."""
        B, S = prompts.shape
        if S > self.max_len:
            raise ValueError(f"prompt length {S} exceeds max_len "
                             f"{self.max_len}")
        ck, cv = self.init_cache(B)
        t0 = time.monotonic()
        with self.server.tracer.span(f"decode/prefill@s{S}",
                                     track="decode") as sp:
            logits, ck, cv = self.server(self.step_fn(0), prompts, ck, cv,
                                         fn_key=self._fn_key(0, S),
                                         priority=self.priority,
                                         deadline_s=self.deadline_s)
            sp.set(batch=B, seq_len=S)
        self.stats.prefill_steps += 1
        self.stats.prefill_latency_s.append(time.monotonic() - t0)
        self.heartbeat.beat()
        return logits, (ck, cv)

    def decode(self, tokens: torch.Tensor, cache, position: int):
        """One decode step: append K/V at ``position``, return next logits.

        ``tokens``: (B, 1) int32; ``position`` is the number of tokens
        already in the cache (prompt + generated so far)."""
        position = int(position)
        if not 0 <= position < self.max_len:
            raise ValueError(f"position {position} outside "
                             f"[0, {self.max_len})")
        ck, cv = cache
        t0 = time.monotonic()
        with self.server.tracer.span(f"decode/step@p{position}",
                                     track="decode"):
            fut = self.server.submit(self.step_fn(position), tokens, ck, cv,
                                     fn_key=self._fn_key(position, 1),
                                     priority=self.priority,
                                     deadline_s=self.deadline_s)
            # position speculation: while this step executes, pre-compile
            # the NEXT position's program (the position ladder advances by
            # one each step)
            if (self.server.config.speculative
                    and position + 1 < self.max_len):
                if self.server.prewarm(self.step_fn(position + 1), tokens,
                                       ck, cv,
                                       fn_key=self._fn_key(position + 1, 1)):
                    self.stats.speculated_positions += 1
            logits, ck, cv = fut.result()
        self.stats.decode_steps += 1
        wall = time.monotonic() - t0
        self.stats.step_latency_s.append(wall)
        self.heartbeat.beat()
        if self.straggler.record(wall):
            self.stats.slow_steps += 1
            if self.server.tracer.enabled:
                self.server.tracer.instant(
                    "decode/slow_step", track="decode", position=position,
                    wall_s=round(wall, 6),
                    ewma_s=round(self.straggler.mean, 6))
        return logits, (ck, cv)

    def generate(self, prompts: torch.Tensor, n_steps: int,
                 caches: list | None = None):
        """Greedy prefill + ``n_steps - 1`` decode steps.

        Returns ``(tokens, logits_list)``: the (B, n_steps) generated ids
        and the per-step logits (prefill last-position logits first).
        ``caches`` (a list), when given, collects the ``(cache_k,
        cache_v)`` pair after every step."""
        return self._generate(prompts, n_steps, True, caches)

    def reference_generate(self, prompts: torch.Tensor, n_steps: int,
                           caches: list | None = None):
        """The eager oracle: the SAME step functions called directly (no
        tm_compile, no server) — the compiled session must be bit-exact
        against this."""
        return self._generate(prompts, n_steps, False, caches)

    def _generate(self, prompts, n_steps: int, served: bool,
                  caches: list | None):
        B, S = prompts.shape
        if S + n_steps > self.max_len:
            raise ValueError(f"prompt {S} + {n_steps} steps exceeds max_len "
                             f"{self.max_len}")
        if served:
            logits, cache = self.prefill(prompts)
        else:
            ck, cv = self.init_cache(B)
            logits, ck, cv = self.step_fn(0)(prompts, ck, cv)
            cache = (ck, cv)
        if caches is not None:
            caches.append(cache)
        logits_list = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [tok]
        for t in range(n_steps - 1):
            if served:
                logits, cache = self.decode(tok, cache, S + t)
            else:
                logits, ck, cv = self.step_fn(S + t)(tok, *cache)
                cache = (ck, cv)
            if caches is not None:
                caches.append(cache)
            logits_list.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1), logits_list
