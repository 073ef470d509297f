from repro_torch.data.generator import lm_batch_stream

__all__ = ["lm_batch_stream"]
