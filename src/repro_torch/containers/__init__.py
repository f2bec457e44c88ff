"""BCL distributed data structures, PyTorch port (paper section 5)."""

from repro_torch.containers.darray import DArraySpec, darray_create, rget, rput
from repro_torch.containers.hashmap import HashMapSpec, hashmap_create
from repro_torch.containers.queue import QueueSpec, queue_create
from repro_torch.containers.bloom import BloomSpec, bloom_create
from repro_torch.containers.hashmap_buffer import HashMapBufferSpec

__all__ = [
    "DArraySpec", "darray_create", "rget", "rput",
    "HashMapSpec", "hashmap_create",
    "QueueSpec", "queue_create",
    "BloomSpec", "bloom_create",
    "HashMapBufferSpec",
]
