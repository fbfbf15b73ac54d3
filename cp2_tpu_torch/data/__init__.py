"""Host-side data layer: file discovery, splits, prefetching loaders."""

from cp2_tpu_torch.data.datasets import (
    get_data_splits,
    get_pretrain_files,
    list_image_mask_pairs,
    pseudo_test_subset,
    read_paths_csv,
)
from cp2_tpu_torch.data.host_loader import (
    HostDataLoader,
    PretrainDataSource,
    SegmentationDataSource,
)

__all__ = [
    "get_data_splits",
    "get_pretrain_files",
    "list_image_mask_pairs",
    "pseudo_test_subset",
    "read_paths_csv",
    "HostDataLoader",
    "PretrainDataSource",
    "SegmentationDataSource",
]
