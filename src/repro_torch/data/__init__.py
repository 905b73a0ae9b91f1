from repro_torch.data.synthetic import make_covertype_like  # noqa: F401
from repro_torch.data.source import (  # noqa: F401
    BlockPrefetcher, DataSource, HostSource, InMemorySource, ManifestSource,
    SyncGather, make_memmap_dataset, open_memmap_dataset, read_manifest,
    split_holdout,
)
