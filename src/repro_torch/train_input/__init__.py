"""BlobShuffle as the training input pipeline (ROADMAP item 5).

``tokens`` encodes step-keyed LM batches as Records, ``pipeline`` drives
the async engine as a double-buffered batch source with committed
offsets, ``specs_check`` validates the sharded input specs, ``loop``
runs the checkpointed train loop with crash/resume. See
``docs/architecture.md`` for the end-to-end data flow.
"""

from repro_torch.train_input.pipeline import ShuffleFedInput
from repro_torch.train_input.tokens import (TokenStreamConfig, assemble_batch,
                                      decode_record, reference_batch,
                                      step_records, step_tokens)

__all__ = [
    "ShuffleFedInput", "TokenStreamConfig", "assemble_batch",
    "decode_record", "reference_batch", "step_records", "step_tokens",
    "SimulatedCrash", "ShuffleTrainResult", "train_shuffle_fed",
    "input_spec_report", "validate_device_batch", "lower_train_step",
]


def __getattr__(name):
    # loop/specs_check pull in jax + the model stack; load them lazily so
    # engine-only consumers of the pipeline stay light
    if name in ("SimulatedCrash", "ShuffleTrainResult",
                "train_shuffle_fed"):
        from repro_torch.train_input import loop
        return getattr(loop, name)
    if name in ("input_spec_report", "validate_device_batch",
                "lower_train_step"):
        from repro_torch.train_input import specs_check
        return getattr(specs_check, name)
    raise AttributeError(name)
