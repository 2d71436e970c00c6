"""RISC-inspired TM instruction encoding (paper Section IV-A).

The TMU executes an *instruction stream*; each instruction activates a subset
of the eight pipeline stages (Fetch, Decode, Tensor Load, Fine-grained TM,
Element-wise, Coarse-grained TM, Tensor Store, Branch).  We encode exactly
that: a :class:`TMInstr` names its source/destination buffers (Tensor Load /
Tensor Store), carries a :class:`~repro_torch.core.affine.MixedRadixMap` when the
coarse-grained stage is active (the (A, B) register contents), an
:class:`RMEConfig` when the fine-grained stage is active (the masking-engine
registers), and an element-wise opcode when that stage is active.  Branch is
implicit: the executor segments long tensors into block iterations.

The encoding is deliberately *data*, not code — serializable via
``TMInstr.encode`` — because the paper's reconfigurability story is that new
operators are new register contents, never new datapaths.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Sequence

from repro_torch.core.affine import MixedRadixMap


class TMOpcode(enum.Enum):
    """Which stages of the generic execution model an instruction drives."""

    COARSE = "coarse"          # coarse-grained TM: address-generator (A,B) map
    FINE_ASSEMBLE = "fine_asm"  # RME assemble: masked gather -> packed stream
    FINE_EVALUATE = "fine_eval"  # RME evaluate: threshold filter -> stream
    ELEMENTWISE = "elementwise"  # Add / Sub / Mul / Max across 2 streams
    COPY = "copy"              # pure load->store (DMA passthrough)
    RESIZE = "resize"          # fine-grained weighted 4-tap gather (paper Resize)


class EwOp(enum.Enum):
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    MAX = "max"


@dataclasses.dataclass(frozen=True)
class RMEConfig:
    """Reconfigurable-masking-engine register contents (paper Fig. 7b).

    ``assemble``: ``byte_mask`` selects lanes, assembled (packed) in order into
    the output stream.  ``evaluate``: ``threshold``/``cmp`` filter the stream,
    emitting selected elements (+ optionally their indices).

    TPU adaptation: byte granularity becomes *lane* granularity (one lane =
    one element of the minor axis); the masking crossbar becomes a vectorized
    prefix-sum compaction (see repro_torch.core.rme).
    """

    scheme: str  # "assemble" | "evaluate"
    # assemble: static lane mask over the minor axis (length = minor dim)
    lane_mask: tuple[int, ...] | None = None
    # evaluate: runtime predicate `value <cmp> threshold` on a score channel
    threshold: float | None = None
    cmp: str = "ge"  # ge | gt | le | lt
    score_index: int = 0      # which minor-axis element carries the score
    top_k: int | None = None  # keep at most k survivors (sorted by score)
    capacity: int | None = None  # static output capacity (padded)

    def encode(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def decode(d: dict) -> "RMEConfig":
        d = dict(d)
        if d.get("lane_mask") is not None:  # JSON round-trips tuples as lists
            d["lane_mask"] = tuple(d["lane_mask"])
        return RMEConfig(**d)


@dataclasses.dataclass(frozen=True)
class TMInstr:
    """One TMU instruction.

    ``srcs``/``dst`` name logical buffers in the executor's buffer file (the
    paper's tensor buffers); the executor's Tensor Load / Tensor Store stages
    resolve them.  Exactly one of ``map_`` / ``rme`` / ``ew`` is set unless the
    instruction fuses stages (e.g. COARSE+ELEMENTWISE for Add-with-layout).
    """

    opcode: TMOpcode
    srcs: tuple[str, ...]
    dst: str
    map_: MixedRadixMap | None = None
    rme: RMEConfig | None = None
    ew: EwOp | None = None
    # Route needs one map per source (each writes its own band)
    maps: tuple[MixedRadixMap, ...] | None = None
    meta: dict | None = None  # free-form operator metadata (e.g. resize scale)

    def __post_init__(self):
        if self.opcode == TMOpcode.COARSE:
            assert self.map_ is not None or self.maps is not None
        if self.opcode in (TMOpcode.FINE_ASSEMBLE, TMOpcode.FINE_EVALUATE):
            assert self.rme is not None
        if self.opcode == TMOpcode.ELEMENTWISE:
            assert self.ew is not None and len(self.srcs) == 2
        if self.opcode == TMOpcode.RESIZE:
            assert self.meta is not None and "out_h" in self.meta \
                and "out_w" in self.meta

    def active_stages(self) -> tuple[str, ...]:
        """Which of the eight pipeline stages this instruction drives.

        Fetch/Decode/Tensor Load/Tensor Store are always active; the middle
        stages depend on the opcode.  The schedule pass charges per-stage
        cycles only for active stages (paper Fig. 3)."""
        mid: tuple[str, ...] = ()
        if self.opcode == TMOpcode.COARSE:
            mid = ("coarse",) + (("elementwise",) if self.ew is not None else ())
            if self.maps is not None and len(self.maps) > 1:
                mid = mid + ("branch",)  # band loop over the Route maps
        elif self.opcode in (TMOpcode.FINE_ASSEMBLE, TMOpcode.FINE_EVALUATE,
                             TMOpcode.RESIZE):
            mid = ("fine",)
        elif self.opcode == TMOpcode.ELEMENTWISE:
            mid = ("elementwise",)
        return ("fetch", "decode", "load") + mid + ("store",)

    def encode(self) -> dict:
        d: dict[str, Any] = {
            "opcode": self.opcode.value,
            "srcs": list(self.srcs),
            "dst": self.dst,
        }
        if self.map_ is not None:
            d["map"] = self.map_.encode()
        if self.maps is not None:
            d["maps"] = [m.encode() for m in self.maps]
        if self.rme is not None:
            d["rme"] = self.rme.encode()
        if self.ew is not None:
            d["ew"] = self.ew.value
        if self.meta:
            d["meta"] = self.meta
        return d

    @staticmethod
    def decode(d: dict) -> "TMInstr":
        return TMInstr(
            opcode=TMOpcode(d["opcode"]),
            srcs=tuple(d["srcs"]),
            dst=d["dst"],
            map_=MixedRadixMap.decode(d["map"]) if "map" in d else None,
            maps=tuple(MixedRadixMap.decode(m) for m in d["maps"]) if "maps" in d else None,
            rme=RMEConfig.decode(d["rme"]) if "rme" in d else None,
            ew=EwOp(d["ew"]) if "ew" in d else None,
            meta=d.get("meta"),
        )


@dataclasses.dataclass
class TMProgram:
    """An ordered TM instruction stream plus buffer declarations.

    ``inputs``/``outputs`` name the external buffers; everything else is
    intermediate (candidate for fusion/elision by the fusion pass).
    """

    instrs: list[TMInstr]
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]

    def encode(self) -> str:
        return json.dumps(
            {
                "instrs": [i.encode() for i in self.instrs],
                "inputs": list(self.inputs),
                "outputs": list(self.outputs),
            }
        )

    @staticmethod
    def decode(s: str) -> "TMProgram":
        d = json.loads(s)
        return TMProgram(
            instrs=[TMInstr.decode(i) for i in d["instrs"]],
            inputs=tuple(d["inputs"]),
            outputs=tuple(d["outputs"]),
        )

    def consumer_indices(self, name: str) -> list[int]:
        return [i for i, ins in enumerate(self.instrs) if name in ins.srcs]

    def intermediates(self) -> list[str]:
        names: list[str] = []
        ext = set(self.inputs) | set(self.outputs)
        for ins in self.instrs:
            if ins.dst not in ext and ins.dst not in names:
                names.append(ins.dst)
        return names
