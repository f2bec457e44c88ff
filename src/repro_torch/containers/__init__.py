"""BCL distributed data structures, PyTorch port: the hash map so far
(the other containers are ROADMAP.md Queue 1 item 6)."""

from repro_torch.containers.hashmap import HashMapSpec, hashmap_create

__all__ = ["HashMapSpec", "hashmap_create"]
