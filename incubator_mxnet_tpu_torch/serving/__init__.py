"""serving/ - the continuous-batching inference plane of the PyTorch port.

- ``wire``      - array manifest <-> payload framing (no pickling);
- ``scheduler`` - shape-bucketed continuous batcher (pad-or-pack, join
                  windows, deadline shed);
- ``decode``    - continuous-batching decode loop over a KV-cache slot grid;
- ``kv_cache``  - the dense slot-granular KV cache;
- ``quant``     - the int8 decode head (Int8Dense) and its knob;
- ``loader``    - checkpoint export/load, generations and live weight
                  swaps, and the model-family registry;
- ``server``    - ModelServer: many models, one RPC endpoint;
- ``client``    - ServingClient: typed calls with wire-level deadlines.
"""

from .client import DeadlineExceeded, Draining, ServingClient, ServingError
from .decode import DecodeLoop, DecodeRequest
from .kv_cache import KVCache
from .loader import (SERVING_FAMILIES, GenerationMismatchError, ServedModel,
                     export_for_serving, generation_steps,
                     load_generation_params, load_served_model,
                     publish_generation, read_generation, serving_family)
from .quant import Int8Dense, int8_serving_enabled
from .scheduler import (ContinuousBatcher, Request, ShedError, bucket_for,
                        default_buckets, pad_batch_rows, pad_to_bucket)
from .server import ModelServer

__all__ = [
    "ContinuousBatcher", "DeadlineExceeded", "DecodeLoop", "DecodeRequest",
    "Draining", "GenerationMismatchError", "Int8Dense", "KVCache",
    "ModelServer",
    "Request", "SERVING_FAMILIES", "ServedModel", "ServingClient",
    "ServingError", "ShedError", "bucket_for", "default_buckets",
    "export_for_serving", "generation_steps", "int8_serving_enabled",
    "load_generation_params", "load_served_model",
    "pad_batch_rows", "pad_to_bucket", "publish_generation",
    "read_generation", "serving_family",
]
