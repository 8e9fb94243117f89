"""Readers and writers: the device Parquet decode, the scan's local file
cache and bind-time snapshots, the file writers (Parquet, ORC, CSV, JSON,
Hive text) with the async write queue, Avro, and the Delta and Iceberg
table formats."""
