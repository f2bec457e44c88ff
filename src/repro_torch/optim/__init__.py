from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.compress import compressed_psum, int8_compress, int8_decompress

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "warmup_cosine",
           "int8_compress", "int8_decompress", "compressed_psum"]
