from repro_torch.serving.engine import (ServeConfig, greedy_sample,
                                        make_decode_step, make_prefill_step)

__all__ = ["ServeConfig", "greedy_sample", "make_decode_step",
           "make_prefill_step"]
