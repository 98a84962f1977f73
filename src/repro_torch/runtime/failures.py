"""Heartbeat-based failure detection (in-process simulation harness;
port of ``repro.runtime.failures``).

At 1000+ node scale, node failure is routine; the trainer composes this
detector with the PCS checkpoint tier: on failure it restores the newest
acked version — from the host-buffer tier when Read Forwarding still
holds it (fast path), else from the durable store.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional


class NodeStatus(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class _Node:
    last_beat: float
    status: NodeStatus = NodeStatus.HEALTHY


class FailureDetector:
    def __init__(self, node_ids: List[str], *, suspect_after_s: float = 1.0,
                 dead_after_s: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        now = clock()
        self.nodes: Dict[str, _Node] = {n: _Node(now) for n in node_ids}

    def heartbeat(self, node: str) -> None:
        n = self.nodes[node]
        n.last_beat = self.clock()
        n.status = NodeStatus.HEALTHY

    def sweep(self) -> Dict[str, NodeStatus]:
        now = self.clock()
        for n in self.nodes.values():
            dt = now - n.last_beat
            if dt >= self.dead_after_s:
                n.status = NodeStatus.DEAD
            elif dt >= self.suspect_after_s:
                n.status = NodeStatus.SUSPECT
        return {k: v.status for k, v in self.nodes.items()}

    def alive(self) -> List[str]:
        self.sweep()
        return [k for k, v in self.nodes.items()
                if v.status != NodeStatus.DEAD]

    def dead(self) -> List[str]:
        self.sweep()
        return [k for k, v in self.nodes.items()
                if v.status == NodeStatus.DEAD]
