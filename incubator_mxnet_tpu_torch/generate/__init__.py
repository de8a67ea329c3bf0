"""Generative inference: decoder LLMs over a paged KV cache on the device.

Counterpart of ``incubator_mxnet_tpu/generate/``:

- :mod:`.paged_kv` - block-table and free-list KV allocator behind the
  ``serving/kv_cache.py`` surface, its pools on the device;
- :mod:`.engine` - chunked prefill, greedy and temperature sampling, and
  draft-model speculative decoding (Leviathan et al., ICML 2023);
- :mod:`.family` - the ``gpt_decoder`` serving family, which puts the
  decoder on ModelServer's slot grid.

Importing this package registers the serving family.
"""

from .paged_kv import KVPoolExhausted, PagedKVCache
from .engine import GenerateEngine, GPTPagedLM
from .family import export_gpt_for_serving, gpt_cache_spec

__all__ = [
    "KVPoolExhausted",
    "PagedKVCache",
    "GenerateEngine",
    "GPTPagedLM",
    "export_gpt_for_serving",
    "gpt_cache_spec",
]
