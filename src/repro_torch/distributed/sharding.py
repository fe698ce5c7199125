"""Logical-axis sharding rules -> partition specs -> DTensor placements.

Every parameter carries logical axis names (``ParamSpec.axes``); these rules
map them onto the production mesh, as the reference's
``repro/distributed/sharding.py`` does, rule for rule.  AVEC's
link-hierarchy rule decides the mapping: tensor-parallel axes ("model")
stay inside a pod, batch crosses ("pod", "data"), and nothing chatty maps
onto the slow link.

Profiles:
  dp_tp   -- baseline: weights sharded over "model" only (replicated over
             data); batch over ("pod", "data").
  fsdp_tp -- the d_model ("embed") weight axis additionally shards over
             "data" (ZeRO-3 style).
  *_hd    -- additionally shard head_dim over "model"; effective only where
             the head axis could not shard (one "model" use per tensor).

Divisibility policy: a dimension shards over an axis group only when the
group's size divides it exactly; otherwise it replicates (minicpm's 36
heads, arctic's 56, mamba2's 24 SSD heads over model 16).

A :class:`PartitionSpec` is a tuple of per-dimension entries (None, a mesh
axis name, or a tuple of names), so it compares equal to the reference's.
:func:`to_placements` turns one into a DTensor placement per mesh
dimension.  The rule functions read only ``mesh.axis_names`` and
``mesh.shape`` (a dict of axis sizes), as ``launch.mesh.Mesh`` gives them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.models.params import ParamSpec, is_spec
from repro_torch.utils import tree_map, tree_map_with_path

# logical axis -> mesh axis group, per profile
_RULES_DP_TP: dict = {
    "vocab": ("model",), "heads": ("model",), "kv_heads": ("model",),
    "mlp": ("model",), "experts": ("model",), "conv_in": ("model",),
    "ssm_heads": ("model",), "expert_mlp": None, "embed": None,
    "head_dim": None, "layers": None, None: None,
}
_RULES_FSDP_TP = dict(_RULES_DP_TP, embed=("data",))
_RULES_DP_TP_HD = dict(_RULES_DP_TP, head_dim=("model",))
_RULES_FSDP_TP_HD = dict(_RULES_FSDP_TP, head_dim=("model",))

PROFILES = {"dp_tp": _RULES_DP_TP, "fsdp_tp": _RULES_FSDP_TP,
            "dp_tp_hd": _RULES_DP_TP_HD, "fsdp_tp_hd": _RULES_FSDP_TP_HD}


class PartitionSpec(tuple):
    """``PartitionSpec("model", None)``: one entry per tensor dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh; ``placements`` are its DTensor
    placements, one per mesh dimension."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


def to_placements(mesh, pspec) -> tuple:
    """One DTensor placement per mesh dimension: ``Shard(i)`` where
    ``pspec[i]`` names that mesh axis, else ``Replicate()``.  ``mesh`` is
    a :class:`~repro_torch.launch.mesh.Mesh` or a ``DeviceMesh``.  An entry
    naming several axes (``("pod", "data")``) shards its tensor dimension
    over each of them, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    axis_names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    dims: dict = {}
    for i, entry in enumerate(pspec):
        for name in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
            if name in dims:
                raise ValueError(f"mesh axis {name!r} used twice in {pspec}")
            dims[name] = i
    unknown = set(dims) - set(axis_names)
    if unknown:
        raise ValueError(f"{pspec} names axes {sorted(unknown)} not in {axis_names}")
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in axis_names)


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def _map_dim(mesh, dim: int, logical, rules) -> Optional[object]:
    axes = rules.get(logical, None)
    if not axes:
        return None
    # shard only on exact divisibility; replicate otherwise
    if dim % _axis_size(mesh, axes) != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def spec_to_pspec(mesh, spec: ParamSpec, profile: str) -> PartitionSpec:
    rules = PROFILES[profile]
    entries = [_map_dim(mesh, d, a, rules) for d, a in zip(spec.shape, spec.axes)]
    # a mesh axis may appear at most once per pspec: keep first occurrence
    seen: set = set()
    clean = []
    for e in entries:
        names = (e if isinstance(e, tuple) else (e,)) if e else ()
        if any(n in seen for n in names):
            clean.append(None)
            continue
        seen.update(names)
        clean.append(e)
    return P(*clean)


def specs_to_shardings(mesh, spec_tree, profile: str = "dp_tp"):
    return tree_map(lambda s: NamedSharding(mesh, spec_to_pspec(mesh, s, profile)),
                    spec_tree, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# Activations / inputs / caches
# ---------------------------------------------------------------------------

def batch_pspec(mesh, batch_size: int, rank: int, seq_axis: Optional[int] = None,
                seq_len: int = 0) -> PartitionSpec:
    """Batch-leading activation sharding: batch over ("pod", "data") when
    it divides; for batch=1 long-context cells, optionally the sequence dim
    over "data" instead."""
    da = data_axes(mesh)
    total = _axis_size(mesh, da)
    entries: list = [None] * rank
    if batch_size >= total and batch_size % total == 0:
        entries[0] = da if len(da) > 1 else da[0]
    elif seq_axis is not None and seq_len >= total and seq_len % total == 0:
        entries[seq_axis] = da if len(da) > 1 else da[0]
    return P(*entries)


def input_shardings(mesh, cfg, abstract_batch: dict) -> dict:
    return {key: NamedSharding(mesh, P() if leaf.ndim == 0
                               else batch_pspec(mesh, leaf.shape[0], leaf.ndim))
            for key, leaf in abstract_batch.items()}


def cache_shardings(mesh, cfg, abstract_cache, batch_size: int, profile: str = "dp_tp"):
    """Decode-cache shardings by leaf name.  Leaf layouts (lm stack):
      k/v/cross_k/cross_v: (nb, B, S, K, hd)     [encdec: (L, B, S, K, hd)]
      conv:                (nb, B, ck-1, D)
      ssm:                 (nb, B, H, P, N)
    Batch shards over ("pod", "data") when divisible; for batch=1 the KV
    sequence dim shards over "data" instead (sequence parallelism).
    Head-like dims shard over "model" when they fit."""
    da = data_axes(mesh)
    d_total = _axis_size(mesh, da)
    m_total = mesh.shape["model"]
    da_entry = da if len(da) > 1 else da[0]
    batch_ok = batch_size >= d_total and batch_size % d_total == 0

    def leaf_sharding(path, leaf):
        name = path[-1]
        entries: list = [None] * leaf.ndim
        if batch_ok:
            entries[1] = da_entry
        if name in ("k", "v", "cross_k", "cross_v"):
            if not batch_ok and leaf.shape[2] % d_total == 0:
                entries[2] = da_entry            # sequence-sharded KV
            if leaf.shape[3] % m_total == 0:
                entries[3] = "model"
            elif profile.endswith("_hd") and leaf.shape[4] % m_total == 0:
                entries[4] = "model"             # KV head_dim sharding
        elif name == "conv":
            if leaf.shape[3] % m_total == 0:
                entries[3] = "model"
        elif name == "ssm":
            if leaf.shape[2] % m_total == 0:
                entries[2] = "model"
        return NamedSharding(mesh, P(*entries))

    return tree_map_with_path(leaf_sharding, abstract_cache)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
