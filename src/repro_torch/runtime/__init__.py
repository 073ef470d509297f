"""The runtime layer of the port: ``FaultTolerantTrainer`` (blob
checkpoints and restart), ``HedgedFetcher`` (a copy of the JAX package's
straggler hedging) and ``elastic_restore_plan`` (the JAX package's file
under the copy rule but for one line: the port's meshes hold no device
array, so the device count is ``new_mesh.size``), whose shardings
``BlobCheckpointer.restore(..., shardings=)`` takes on a ``StackedMesh``.
The restore onto a ``ProcessGroupMesh``, one block a process, is not
ported (``ROADMAP.md`` queue 1 item 6)."""

from repro_torch.runtime.fault_tolerance import FaultTolerantTrainer
from repro_torch.runtime.stragglers import HedgedFetcher
from repro_torch.runtime.elastic import elastic_restore_plan
