"""The runtime layer of the port: ``FaultTolerantTrainer`` (blob
checkpoints and restart) and ``HedgedFetcher`` (a copy of the JAX
package's straggler hedging). The JAX package's ``elastic_restore_plan``
derives shardings for another mesh through ``distributed.sharding``'s
``named_shardings``, whose parameter part is not ported (``ROADMAP.md``
queue 1 item 4); it comes with it."""

from repro_torch.runtime.fault_tolerance import FaultTolerantTrainer
from repro_torch.runtime.stragglers import HedgedFetcher
