"""Data generators and the dedup pipeline of the PyTorch port (see ``repro.data``)."""

from repro_torch.data.tokens import TokenStream, synth_batch
from repro_torch.data.genomics import GenomeSim, extract_kmers, pack_kmers
from repro_torch.data.dedup import Deduper, DedupSpec

__all__ = ["TokenStream", "synth_batch", "GenomeSim", "extract_kmers",
           "pack_kmers", "Deduper", "DedupSpec"]
