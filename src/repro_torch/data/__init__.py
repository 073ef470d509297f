from repro_torch.data.generator import (LoadGenerator, lm_batch_stream,
                                        shufflebench_records)

__all__ = ["LoadGenerator", "lm_batch_stream", "shufflebench_records"]
