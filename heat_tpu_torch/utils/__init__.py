"""Utilities (counterpart of ``heat_tpu/utils/``)."""
from . import checkpointing, data, profiling
from .checkpointing import load_checkpoint, save_checkpoint
