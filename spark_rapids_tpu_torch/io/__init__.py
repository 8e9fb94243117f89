"""Readers: the device Parquet decode and the scan's local file cache."""
