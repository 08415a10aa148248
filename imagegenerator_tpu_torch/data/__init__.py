"""Host-side data pipeline: storage adapters, the COCO caption dataset,
caption tokenizers and a prefetching device loader."""
