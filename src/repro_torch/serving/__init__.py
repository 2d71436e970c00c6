"""``repro_torch.serving`` — compile-cached, shape-bucketed TMU serving runtime.

The paper keeps the TMU and TPU overlapped with ping-pong buffers inside one
program; this subsystem applies the same scheme at *request* granularity:

* :class:`TMServer` (server.py) — the request surface: futures in, batched
  pipelined execution, bit-exact results out;
* :class:`CompileCache` (cache.py) — LRU over
  ``(fn, shapes, dtypes, backend, CycleParams)`` so ``tm_compile`` runs once
  per shape class;
* shape-bucketed micro-batching (batcher.py) — pad/coalesce/split around
  the vmap batch lift;
* :class:`RequestPipeline` (pipeline.py) — depth-limited admission of
  compiled phase DAGs onto the per-engine (TMU/TPU) streams of
  :mod:`repro_torch.runtime.streams`, double-buffering requests across engines;
* :class:`ServerStats` (stats.py) — throughput/latency accounting + the
  measured-from-event-timestamps overlap ratio next to the cycle model's
  prediction;
* :class:`DecodeSession` (decode.py) — position-bucketed LM decode: one
  decoder layer per step through the server, one pinned program per
  ``(position, seq_len)``, the KV cache riding the request path.

Observability: ``ServerConfig(trace=True)`` (or ``trace=<repro_torch.obs.Tracer>``)
threads one span timeline through admission, compile, phase execution and
the engine streams — see :mod:`repro_torch.obs` and ``docs/observability.md``.
"""

from repro_torch.serving.batcher import (BucketKey, Request, bucket_size,
                                         coalesce, split)
from repro_torch.serving.cache import CacheEntry, CacheKey, CompileCache
from repro_torch.serving.pipeline import PipelineJob, RequestPipeline
from repro_torch.serving.server import (DrainTimeoutError, ServerConfig,
                                        TMServer, predict_cycles,
                                        predict_overlap, predict_phase_cycles,
                                        select_chain_fusion,
                                        select_cycle_params)
from repro_torch.serving.stats import ServerStats, latency_percentiles
from repro_torch.serving.decode import (DecodeSession, DecodeStats,
                                        make_layer_step)

__all__ = [
    "BucketKey", "Request", "bucket_size", "coalesce", "split",
    "CacheEntry", "CacheKey", "CompileCache",
    "PipelineJob", "RequestPipeline",
    "DrainTimeoutError", "ServerConfig", "TMServer", "predict_cycles",
    "predict_overlap", "predict_phase_cycles", "select_chain_fusion",
    "select_cycle_params",
    "ServerStats", "latency_percentiles",
    "DecodeSession", "DecodeStats", "make_layer_step",
]
