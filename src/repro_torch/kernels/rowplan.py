"""The launch plan shared by the row kernels that hold a row in registers
(``csrc/rmsnorm.cu``, ``csrc/comm_quant.cu``'s quantize).

Each row is read once in 16-byte vectors (8 bf16 or 4 fp32 a load) held in
registers; the threads that serve a row follow D (a power of two up to 32,
or a multiple of 32), and a block packs as many rows as bring it to about
``THREADS`` threads.  A row that does not lie on 16 bytes, a D that is not
a multiple of the vector, or a row wider than ``MAX_PER`` vectors a thread
takes the kernel's scalar loop (``per`` 0).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

__all__ = ["Plan", "row_plan", "THREADS", "MAX_PER"]

THREADS = 256            # threads a block aims for
MAX_PER = 8              # 16-byte vectors a thread may hold (D up to 16384 bf16)


class Plan(NamedTuple):
    """How a row kernel covers the rows: thread ``t`` of block ``blk``
    serves row ``blk * rpb + t // tpr``; in the vector path (``per`` > 0)
    it holds the row's 16-byte vectors ``t % tpr + k * tpr`` for ``k <
    per`` (those below ``D / vec``), in the scalar loop (``per`` 0) the
    elements ``t % tpr + k * tpr`` below D."""
    per: int       # vectors a thread holds; 0: the scalar loop
    tpr: int       # threads per row: a power of two up to 32, or a multiple of 32
    rpb: int       # rows per block
    vec: int       # elements per 16-byte vector


@functools.lru_cache(maxsize=256)
def row_plan(D: int, itemsize: int, aligned: bool, min_per: int = 1) -> Plan:
    """The launch plan for rows of D elements of ``itemsize`` bytes;
    ``aligned``: every row (and whatever else the kernel reads or writes
    in vectors) lies on the vector's alignment.  The vector path takes
    aligned rows whose D is a multiple of the vector and fits in
    ``MAX_PER`` vectors a thread; every other row takes the scalar loop.
    A thread holds at least ``min_per`` vectors (a power of two), so that
    many loads are in flight per thread even on narrow rows."""
    vec = 16 // itemsize
    per, units = 0, min(D, THREADS)
    if aligned and D % vec == 0:
        nvec = D // vec
        p = min_per
        while p * THREADS < nvec:
            p *= 2
        if p <= MAX_PER:
            per, units = p, -(-nvec // p)
    tpr = 1 << (units - 1).bit_length() if units <= 32 else -(-units // 32) * 32
    return Plan(per, tpr, max(1, THREADS // tpr), vec)
