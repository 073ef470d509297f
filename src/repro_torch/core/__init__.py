"""Paper-faithful BlobShuffle: records → Batcher → object store (+caches)
→ notifications → Debatcher, with the §4 analytical model, calibrated
capacity/latency models, and the §5 discrete-event simulator."""

from repro_torch.core.records import (Record, serialize, deserialize,
                                deserialize_all, default_partitioner)
from repro_torch.core.recordbatch import (RecordBatch, fnv1a_batch,
                                    default_partitioner_batch)
from repro_torch.core.blob import (Blob, BlobIndex, ByteRange, Notification,
                             build_blob, build_blob_from_buffers,
                             extract, extract_batch)
from repro_torch.core.formats import (WIRE_MAGIC, BlobFormat, BlobFormatError,
                                ColumnarV2, CorruptBlobError, RawV1,
                                UnknownFormatError, detect_format,
                                get_format, register_format,
                                registered_formats)
from repro_torch.core.stores import (BlobStore, SimulatedS3, LatencyModel,
                               StoreCosts, StoreStats, StoreError,
                               SlowDownError, TransientStoreError,
                               StoreTimeoutError, ExpressOneZoneStore,
                               FaultyStore, FaultStats)
from repro_torch.core.cache import (LRUCache, SingleFlight, DistributedCache,
                              LocalCache)
from repro_torch.core.batcher import Batcher, BlobShuffleConfig
from repro_torch.core.debatcher import Debatcher
from repro_torch.core.commit import CommitCoordinator
from repro_torch.core.events import EventLoop
from repro_torch.core.engine import (AsyncShuffleEngine, EngineConfig,
                               ShuffleMetrics)
from repro_torch.core.strategy import (COMBINERS, STRATEGIES, CombiningStrategy,
                                 DefaultStrategy, LastWinsCombiner,
                                 PushStrategy, ShuffleStrategy,
                                 StrategyStats, SumU64Combiner,
                                 TwoRoundMergeStrategy, make_strategy)
from repro_torch.core.workload import (WorkloadConfig, drive, generate,
                                 generate_batch)
from repro_torch.core.pipeline import BlobShufflePipeline
from repro_torch.core.analytical import ModelParams
from repro_torch.core.capacity import CapacityModel
from repro_torch.core.costs import (AwsPrices, TierPrices, TIERS,
                              blobshuffle_cost_per_hour, dollars_per_gib,
                              kafka_shuffle_cost_per_hour,
                              shuffle_cost_per_logical_gib)
from repro_torch.core.simulator import (SimConfig, SimResult, simulate,
                                  simulate_async, simulate_elastic)
