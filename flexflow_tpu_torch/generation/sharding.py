"""Serving layout: how the generation engine's state splits over the
ranks of a tensor-parallel group (port of
``flexflow_tpu/generation/sharding.py``).

The layout is Megatron-style intra-layer tensor parallelism over the
``"model"`` axis (``parallel/mesh.py::serving_mesh``), chosen for
decode: the KV cache, the thing that outgrows one device in serving,
splits along its head axis; each rank's attention runs over its own KV
heads only; the cross-rank boundaries are the sum all-reduces after the
head-split attention output projection and after the row-split FFN
down projection (``parallel/distributed.py::all_reduce``).

Per-leaf placement of the decoder parameters (decoder.py), rank r of N:

  wq/wk/wv  [E, H, D]   heads [r*H/N, (r+1)*H/N)
  wo        [H, D, E]   the same heads (row-parallel: partial sums)
  ff1       [E, F]      columns [r*F/N, (r+1)*F/N)  (column-parallel)
  ff1_b     [F]         the same columns
  ff2       [F, E]      the same rows               (row-parallel)
                        (ff1/ff1_b/ff2 only when N divides F; otherwise
                        the FFN stays whole on every rank, with no
                        reduce: the layout degrades, it never errors)
  everything else       whole on every rank (``ff2_b`` is added once,
                        after the reduce)

and of the engine's runtime state:

  KV cache k/v [L, num_blocks, block_size, H/N, D] on each rank
  block tables / positions / sampling params / tokens   on every rank

Block tables and the host-side allocator are therefore the same on every
rank: a block id means the same (block, offset) slot everywhere, only
the heads held there differ. A degree-1 layout changes nothing: the
engine is the single-device engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..parallel.mesh import MODEL_AXIS, ServingMesh, serving_mesh


def validate_kv_shards(num_kv_heads: int, tp_degree: int) -> None:
    """KV heads divide across shards: a degree that does not divide them
    would need uneven head slices."""
    if tp_degree < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    if num_kv_heads % tp_degree != 0:
        raise ValueError(
            f"num_kv_heads % tp_degree != 0: {num_kv_heads} KV heads do "
            f"not divide across {tp_degree} shards; pick a tp_degree "
            f"that divides the head count"
        )


@dataclasses.dataclass(frozen=True)
class ServingLayout:
    """One engine's serving mesh and the per-rank slices of its state."""

    mesh: ServingMesh
    tp_degree: int
    num_heads: int

    @classmethod
    def build(
        cls,
        num_heads: int,
        tp_degree: int = 1,
        mesh: Optional[ServingMesh] = None,
        devices=None,
    ) -> "ServingLayout":
        validate_kv_shards(num_heads, tp_degree)
        if mesh is None:
            mesh = serving_mesh(tp_degree, devices)
        elif MODEL_AXIS not in mesh.axis_names:
            raise ValueError(
                f"serving mesh must carry a '{MODEL_AXIS}' axis, got "
                f"{mesh.axis_names}"
            )
        return cls(mesh=mesh, tp_degree=tp_degree, num_heads=num_heads)

    @property
    def heads_per_shard(self) -> int:
        return self.num_heads // self.tp_degree

    def head_slice(self, rank: int) -> slice:
        """Rank ``rank``'s contiguous KV heads."""
        n = self.heads_per_shard
        return slice(rank * n, (rank + 1) * n)

    def ffn_sharded(self, ff_size: int) -> bool:
        """Whether the FFN splits (column-parallel up, row-parallel down):
        only when the degree divides the ff width."""
        return self.tp_degree > 1 and ff_size % self.tp_degree == 0

    def shard_params(self, params: Dict[str, Any], rank: int) -> Dict[str, Any]:
        """Rank ``rank``'s slice of a decoder parameter dictionary (the
        table in the module doc). Slices are contiguous copies, so a rank
        holds only its own part."""
        hs = self.head_slice(rank)

        def layer_shard(layer: Dict[str, Any]) -> Dict[str, Any]:
            out = dict(layer)
            for name in ("wq", "wk", "wv"):
                out[name] = layer[name][:, hs].contiguous()
            out["wo"] = layer["wo"][hs].contiguous()
            f = layer["ff1"].shape[1]
            if self.ffn_sharded(f):
                n = f // self.tp_degree
                cols = slice(rank * n, (rank + 1) * n)
                out["ff1"] = layer["ff1"][:, cols].contiguous()
                out["ff1_b"] = layer["ff1_b"][cols].contiguous()
                out["ff2"] = layer["ff2"][cols].contiguous()
            return out

        out = {k: v for k, v in params.items() if k != "layers"}
        out["layers"] = [layer_shard(layer) for layer in params["layers"]]
        return out

    def describe(self) -> Dict[str, Any]:
        """Metadata block: mesh geometry + the per-tensor specs."""
        return {
            "tp_degree": self.tp_degree,
            "mesh_devices": self.mesh.size,
            "mesh_axes": dict(self.mesh.shape),
            "kv_heads_per_shard": self.num_heads // self.tp_degree,
            "specs": {
                "cache_kv": f"[L, blocks, block, H/{self.tp_degree}, D]",
                "wq/wk/wv": f"[E, H/{self.tp_degree}, D]",
                "wo": f"[H/{self.tp_degree}, D, E]",
                "block_tables": "replicated",
                "sampling_state": "replicated",
            },
        }


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank's forward needs of the group: its rank and degree,
    whether the FFN is split, and the group its reduces run over
    (``parallel/distributed.py::TPGroup``)."""

    rank: int
    tp_degree: int
    ffn_sharded: bool
    group: Any

    def all_reduce(self, t):
        """Sum ``t`` over the ranks (returns the reduced tensor)."""
        from ..parallel.distributed import all_reduce

        return all_reduce(t.contiguous(), self.group)
