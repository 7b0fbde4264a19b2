"""Token data of the training slice: the synthetic stream, memmap shards
and the prefetcher (``repro.data`` counterparts)."""
