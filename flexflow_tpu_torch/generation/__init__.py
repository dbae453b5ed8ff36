"""Autoregressive generation: the block KV cache, the decoder's four
forwards, the generation engine and the continuous-batching scheduler
(port of ``flexflow_tpu/generation``)."""
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

__all__ = [
    "BlockAllocator",
    "CacheConfig",
    "ContinuousBatchingScheduler",
    "DecoderParams",
    "GenerationEngine",
    "GenerationHandle",
    "KVCache",
    "Request",
    "SamplingParams",
    "decode_step",
    "decoder_params_from_numpy",
    "default_buckets",
    "forward_full",
    "init_decoder_params",
    "prefill",
    "slot_mapping",
    "verify_step",
]
