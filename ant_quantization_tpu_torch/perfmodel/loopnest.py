"""Loop-nest IR with memory-op hoisting for the performance model.

Rebuild of the reference's LoopStack
(ant_simulator/bitfusion/src/simulator/loop_stack.py:76-98): a tiling
schedule is a nest of counted loops, each carrying a per-namespace access
stride; memory reads/writes sit at some loop level and can be *promoted*
(hoisted) outward through any loop that either does not advance their
namespace (stride 0 — the op is loop-invariant) or whose whole footprint
still fits in the namespace's SRAM (size x count buffers on chip). Each
promotion through a striding loop multiplies the op's transfer size; the
resulting DRAM traffic is size x (product of the loop counts still
enclosing the op).

The analytic tiling model (perfmodel/model.py get_stats_fast + the native
csrc/tileopt.cc search) computes the same quantity closed-form; this IR is
the explicit, inspectable form — useful for validating the closed-form
counts on small cases and for modeling schedules the closed form does not
cover.

The port's copy of the reference's ``perfmodel/loopnest.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

__all__ = ["Loop", "MemOp", "LoopNest"]


@dataclasses.dataclass
class Loop:
    """One counted loop; ``strides[ns]`` = 0 when the loop does not advance
    namespace ``ns`` (reads of it repeat identically each iteration)."""
    name: str
    count: int
    strides: Dict[str, int]


@dataclasses.dataclass
class MemOp:
    """A DRAM<->SRAM transfer of ``size`` bytes for namespace ``ns``
    issued at loop depth ``level`` (0 = outermost)."""
    ns: str
    size: int
    write: bool = False
    level: int = 0           # depth in the nest where the op starts
    name: str = ""

    # set by promotion:
    promoted_level: Optional[int] = None
    promoted_size: Optional[int] = None


class LoopNest:
    """An ordered nest of loops (index 0 outermost) plus memory ops."""

    def __init__(self, loops: List[Loop]):
        self.loops = list(loops)
        self.ops: List[MemOp] = []

    def add_read(self, ns: str, size: int, level: Optional[int] = None,
                 name: str = "") -> MemOp:
        return self._add(ns, size, False, level, name)

    def add_write(self, ns: str, size: int, level: Optional[int] = None,
                  name: str = "") -> MemOp:
        return self._add(ns, size, True, level, name)

    def _add(self, ns, size, write, level, name):
        op = MemOp(ns=ns, size=size, write=write,
                   level=len(self.loops) if level is None else level,
                   name=name or f"{'wr' if write else 'rd'}_{ns}")
        self.ops.append(op)
        return op

    def promote(self, sram_bytes: Dict[str, int]) -> None:
        """Hoist every op outward while the enclosing loop is
        namespace-invariant (stride 0) or the op's grown footprint fits
        the namespace SRAM (loop_stack.py:76-98 semantics: stride-0 hoists
        are free; striding hoists multiply the buffered size)."""
        for op in self.ops:
            size = op.size
            level = min(op.level, len(self.loops))
            while level > 0:
                loop = self.loops[level - 1]
                stride = loop.strides.get(op.ns, 0)
                if stride == 0:
                    level -= 1
                    continue
                if sram_bytes.get(op.ns, 0) > size * loop.count:
                    size *= loop.count
                    level -= 1
                    continue
                break
            op.promoted_level = level
            op.promoted_size = size

    def traffic(self) -> Dict[str, int]:
        """Total DRAM bytes per namespace after promotion (call promote
        first; unpromoted nests count every op at its issue level)."""
        out: Dict[str, int] = {}
        for op in self.ops:
            level = op.promoted_level if op.promoted_level is not None \
                else op.level
            size = op.promoted_size if op.promoted_size is not None \
                else op.size
            trips = math.prod(l.count for l in self.loops[:level])
            out[op.ns] = out.get(op.ns, 0) + size * trips
        return out

    def describe(self) -> str:
        lines = []
        for i, l in enumerate(self.loops):
            lines.append("  " * i + f"for {l.name} in range({l.count}):")
        for op in self.ops:
            lvl = op.promoted_level if op.promoted_level is not None \
                else op.level
            kind = "write" if op.write else "read"
            size = op.promoted_size if op.promoted_size is not None \
                else op.size
            lines.append("  " * lvl + f"{kind} {op.ns} [{size} B]")
        return "\n".join(lines)
