"""Datasets, augmentation and the prefetching loader."""
