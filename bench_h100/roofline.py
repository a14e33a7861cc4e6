"""The least bytes the traversal's work needs, and the card's peaks.

A traced closest-hit ray reads its origin and direction once (24 bytes)
and writes its hit once: t, triangle, u, v (16 bytes).  A traced shadow
ray reads its origin and direction and writes one flag (25 bytes).  Each
traversal launch reads the scene's vertices once (36 bytes a triangle).
It is a bound by bytes, not by operations: the tests a ray needs depend
on the accel, so a count of them would change with the program, while
these bytes are the same for every implementation of the same inputs."""

from __future__ import annotations

import json
from pathlib import Path

CLOSEST_RAY_BYTES = 24 + 16
SHADOW_RAY_BYTES = 24 + 1
VERTEX_BYTES = 36


def traversal_bytes(segments: int, shadow_segments: int, traversal_launches: int, triangles: int) -> int:
    """Least bytes of the traversal over `segments` closest-hit rays,
    `shadow_segments` shadow rays and `traversal_launches` kernel launches
    over a scene of `triangles`."""
    return (segments * CLOSEST_RAY_BYTES + shadow_segments * SHADOW_RAY_BYTES
            + traversal_launches * triangles * VERTEX_BYTES)


def peaks(kind: str) -> dict:
    """The published peaks of the card named `kind` (peaks.json); a card
    not in the table has none, and no share of a peak is read on it."""
    table = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    return table.get(kind, {})
