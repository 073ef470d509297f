"""Elastic scaling: restore a checkpoint onto a different mesh.

Checkpoints store whole (unsharded) arrays, so elasticity is a sharding
decision at restore time: build the new mesh, derive new NamedShardings
from the same logical-axis rules, and device_put. The data pipeline
rescales per-host batch = global_batch / new_dp. Used by
``BlobCheckpointer.restore(..., shardings=...)`` and tested end-to-end on
8→4→8 host devices.
"""

from __future__ import annotations

from typing import Any, Dict


from repro_torch.distributed.sharding import ShardingRules, named_shardings


def elastic_restore_plan(defs, rules: ShardingRules, new_mesh
                         ) -> Dict[str, Any]:
    """Shardings + per-host batch scaling for the new topology."""
    shardings = named_shardings(defs, rules, new_mesh)
    dp = 1
    for ax in ("pod", "data"):
        if ax in new_mesh.shape:
            dp *= new_mesh.shape[ax]
    return {"shardings": shardings, "dp_degree": dp,
            "devices": new_mesh.size}
