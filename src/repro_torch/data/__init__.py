from repro_torch.data.synthetic import (  # noqa: F401
    make_benchmark_suite, make_covertype_like, make_gaussian_blobs,
    make_nonlinear, make_two_moons, make_xor, train_test_split)
from repro_torch.data.pipeline import (  # noqa: F401
    BigramPipeline, Prefetcher,
)
from repro_torch.data.source import (  # noqa: F401
    BlockPrefetcher, DataSource, HostSource, InMemorySource, ManifestSource,
    MeshPrefetcher, RingSnapshot, RingSource, SyncGather, SyncMeshGather,
    make_memmap_dataset,
    open_memmap_dataset, read_manifest, split_holdout,
)
