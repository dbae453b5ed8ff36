"""Autoregressive generation: the block KV cache, the decoder's four
forwards, the generation engine (its fixed-shape steps replayed as CUDA
graphs on a GPU), speculative decoding and the continuous-batching
scheduler (port of ``flexflow_tpu/generation``)."""
from .cache import BlockAllocator, CacheConfig, KVCache, slot_mapping
from .convert import decoder_params_from_numpy
from .decoder import (
    DecoderParams,
    decode_step,
    forward_full,
    init_decoder_params,
    prefill,
    verify_step,
)
from .engine import GenerationEngine, SamplingParams, default_buckets
from .scheduler import ContinuousBatchingScheduler, GenerationHandle, Request
from .speculative import DraftModelDrafter, NgramDrafter, SpeculationConfig

__all__ = [
    "BlockAllocator",
    "CacheConfig",
    "ContinuousBatchingScheduler",
    "DecoderParams",
    "DraftModelDrafter",
    "GenerationEngine",
    "GenerationHandle",
    "KVCache",
    "NgramDrafter",
    "Request",
    "SamplingParams",
    "SpeculationConfig",
    "decode_step",
    "decoder_params_from_numpy",
    "default_buckets",
    "forward_full",
    "init_decoder_params",
    "prefill",
    "slot_mapping",
    "verify_step",
]
